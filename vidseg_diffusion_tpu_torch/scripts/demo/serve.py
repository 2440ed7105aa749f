"""Browser demo: txt2img / img2img / img2vid over the sampling API (PyTorch).

Counterpart of the repository's scripts/demo/serve.py (the reference's
Streamlit demos, scripts/demo/sampling.py, video_sampling.py,
streamlit_helpers.py:478-798, as a stdlib HTTP app): a form for prompt,
sampler, steps, scale, size and seed; `/` the form, `/health` JSON,
`/generate` a PNG (txt2img, img2img) or an animated GIF (img2vid) from
`inference/api.SamplingPipeline`; an error answers JSON with status 500.

    python -m vidseg_diffusion_tpu_torch.scripts.demo.serve --config configs/inference/sd_2_1.yaml \\
        [--ckpt checkpoints/sd21.safetensors] [--port 7860] [--device cuda] [--dtype bfloat16]

The model is built once at start-up on --device (the card unless the caller
asks for the CPU; without a card the default fails), and requests take turns
through a lock (one card). The server listens on the loopback address unless
--host says otherwise (it is unauthenticated). img2img and img2vid read the
`init_path` field as a file under --init-root (default: the working
directory); a path that escapes it is refused. img2vid needs an SVD config
(configs/inference/svd.yaml). A seed becomes torch.Generator(device).manual_seed(seed).
Prompts are CLIP-BPE tokenized (io/tokenizer.py: --bpe-path, else the
production vocabulary where it is found; the empty prompt needs none).
"""

import argparse
import io
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>vidseg_diffusion_tpu_torch demo</title><style>
body {{ font-family: sans-serif; max-width: 720px; margin: 2em auto; }}
label {{ display: inline-block; width: 9em; }}
input, select {{ margin: 0.2em 0; }}
img {{ max-width: 100%; border: 1px solid #ccc; margin-top: 1em; }}
</style></head><body>
<h2>vidseg_diffusion_tpu_torch &mdash; diffusion demo ({device})</h2>
<form method="post" action="/generate">
<div><label>mode</label><select name="mode">
  <option value="auto">auto (img2img if init path set)</option>
  <option value="txt2img">txt2img</option>
  <option value="img2img">img2img</option>
  <option value="img2vid">img2vid (SVD config)</option>
</select></div>
<div><label>prompt</label><input name="prompt" size="50" value="{prompt}"></div>
<div><label>negative prompt</label><input name="negative" size="50" value=""></div>
<div><label>sampler</label><select name="sampler">{samplers}</select></div>
<div><label>steps</label><input name="steps" type="number" value="25" min="1" max="100"></div>
<div><label>cfg scale</label><input name="scale" value="5.0"></div>
<div><label>width</label><input name="width" type="number" value="{w}" step="64"></div>
<div><label>height</label><input name="height" type="number" value="{h}" step="64"></div>
<div><label>seed</label><input name="seed" type="number" value="0"></div>
<div><label>init image path</label><input name="init_path" size="40" value="">
     <label>strength</label><input name="strength" value="0.75" size="5"></div>
<div><label>frames (img2vid)</label><input name="num_frames" type="number" value="14" min="2">
     <label>motion bucket</label><input name="motion_bucket_id" type="number" value="127"></div>
<div><button type="submit">Generate</button></div>
</form>
{image}
</body></html>
"""


def load_init(path: str, width: int, height: int) -> np.ndarray:
    """An image file as [1, height, width, 3] in [-1, 1] (PIL's default
    resize, as the JAX demo)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(img, np.float32)[None] / 127.5 - 1.0


def to_uint8(frames: torch.Tensor) -> np.ndarray:
    """[..., H, W, 3] in [0, 1] -> uint8 (truncated, as the JAX demo)."""
    return (frames.float().cpu().numpy() * 255).astype(np.uint8)


class DemoApp:
    """The sampling API over one pipeline built from `config`, on `device` in
    `dtype` (bf16 on the card, fp32 on the CPU when not given)."""

    def __init__(self, config: str, ckpt=None, default_size: int = 512, init_root: str = ".", device="cuda",
                 dtype=None, bpe_path=None):
        from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
        from vidseg_diffusion_tpu_torch.inference.api import SamplingPipeline

        self.device = torch.device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.pipeline = build_pipeline(config, ckpt_path=ckpt, dtype=self.dtype, device=self.device)
        self.api = SamplingPipeline(self.pipeline)
        self.default_size = default_size
        self.lock = threading.Lock()
        self.bpe_path = bpe_path
        self.init_root = init_root

    def generator(self, form: dict) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(form.get("seed", 0)))

    def _tokens(self, text: str, batch: int = 1) -> np.ndarray:
        from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize, tokenize_empty

        if not text.strip():
            return tokenize_empty(batch)
        return tokenize([text.strip()] * batch, bpe_path=self.bpe_path)

    def _resolve_init_path(self, init_path: str) -> str:
        """The file under --init-root that `init_path` names; a path that
        escapes the root (absolute, .., a symlink out) raises PermissionError:
        the field would otherwise let anyone who reaches the socket read any
        file into PIL."""
        root = os.path.realpath(self.init_root)
        resolved = os.path.realpath(os.path.join(root, init_path))
        if os.path.commonpath([resolved, root]) != root:
            raise PermissionError(f"init image path escapes --init-root ({root})")
        return resolved

    def sampling_params(self, form: dict):
        from vidseg_diffusion_tpu_torch.inference.api import Sampler, SamplingParams

        return SamplingParams(
            width=int(form.get("width", self.default_size)), height=int(form.get("height", self.default_size)),
            steps=int(form.get("steps", 25)), scale=float(form.get("scale", 5.0)),
            sampler=Sampler(form.get("sampler", Sampler.EULER_EDM.value)),
            img2img_strength=float(form.get("strength", 0.75)))

    def video_params(self, form: dict):
        from vidseg_diffusion_tpu_torch.inference.api import VideoSamplingParams

        return VideoSamplingParams(
            width=int(form.get("width", self.default_size)), height=int(form.get("height", self.default_size)),
            steps=int(form.get("steps", 25)), num_frames=int(form.get("num_frames", 14)),
            motion_bucket_id=int(form.get("motion_bucket_id", 127)), cond_aug=float(form.get("cond_aug", 0.02)))

    def generate_video(self, form: dict) -> bytes:
        """img2vid: SVD image -> video as an animated GIF (the reference's
        video_sampling.py writes an mp4; a GIF keeps the server free of
        codecs)."""
        from PIL import Image

        init_path = form.get("init_path", "").strip()
        if not init_path:
            raise ValueError("img2vid needs an init image path")
        vparams = self.video_params(form)
        arr = load_init(self._resolve_init_path(init_path), vparams.width, vparams.height)
        with self.lock:
            out = self.api.image_to_video(vparams, arr, generator=self.generator(form))
        pil = [Image.fromarray(f) for f in to_uint8(out)]
        buf = io.BytesIO()
        pil[0].save(buf, format="GIF", save_all=True, append_images=pil[1:],
                    duration=int(1000 / max(int(form.get("fps_id", 6)) + 1, 1)), loop=0)
        return buf.getvalue()

    def generate(self, form: dict) -> bytes:
        """txt2img, or img2img when an init path is set (mode 'auto') or
        asked for: one PNG."""
        from PIL import Image

        params = self.sampling_params(form)
        tokens = self._tokens(form.get("prompt", ""))
        neg = self._tokens(form.get("negative", ""))
        mode = form.get("mode", "auto")
        init_path = form.get("init_path", "").strip()
        if mode == "txt2img":
            init_path = ""
        elif mode == "img2img" and not init_path:
            raise ValueError("img2img needs an init image path")
        if init_path:
            init_path = self._resolve_init_path(init_path)
        with self.lock:
            if init_path:
                arr = load_init(init_path, params.width, params.height)
                out = self.api.image_to_image(params, arr, tokens, neg, generator=self.generator(form))
            else:
                out = self.api.text_to_image(params, tokens, neg, generator=self.generator(form))
        buf = io.BytesIO()
        Image.fromarray(to_uint8(out[0])).save(buf, format="PNG")
        return buf.getvalue()


def make_handler(app: DemoApp):
    from vidseg_diffusion_tpu_torch.inference.api import Sampler

    options = "".join(f'<option value="{s.value}">{s.name}</option>' for s in Sampler)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, content_type: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                html = _PAGE.format(prompt="", samplers=options, image="", w=app.default_size, h=app.default_size,
                                    device=app.device).encode()
                self._send(200, "text/html; charset=utf-8", html)
            elif self.path == "/health":
                self._send(200, "application/json", json.dumps({"ok": True}).encode())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            form = dict(urllib.parse.parse_qsl(self.rfile.read(n).decode()))
            is_video = form.get("mode") == "img2vid"
            try:
                body = app.generate_video(form) if is_video else app.generate(form)
            except Exception as e:  # the browser gets the error; the server keeps serving
                self._send(500, "application/json", json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())
                return
            self._send(200, "image/gif" if is_video else "image/png", body)

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/inference/sd_2_1.yaml")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--host", default="127.0.0.1", help="loopback by default: the server is unauthenticated")
    p.add_argument("--init-root", default=".", help="directory init-image paths are confined to")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    p.add_argument("--bpe-path", default=None, help="the CLIP BPE vocabulary for non-empty prompts")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(args.dtype)
    app = DemoApp(args.config, args.ckpt, default_size=args.size, init_root=args.init_root, device=args.device,
                  dtype=dtype, bpe_path=args.bpe_path)
    name = torch.cuda.get_device_name(app.device) if app.device.type == "cuda" else "cpu"
    print(f"device: {app.device} ({name}), dtype: {app.dtype}", flush=True)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    print(f"demo up at http://{args.host}:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
