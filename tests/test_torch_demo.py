"""The port's demo server and sampling CLI (vidseg_diffusion_tpu_torch/
scripts/demo/serve.py, sampling.py) over HTTP on the CPU, at tiny sizes.

The server on sd_tiny.yaml at 64x64 (device "cpu", fp32): the index page
carries the form fields of the repository's scripts/demo/serve.py (the JAX
demo), /health, a txt2img PNG equal pixel for pixel to the sampling API's
output for the same seed and parameters, img2img from a file under
--init-root (equal to image_to_image's), a path that escapes the root
refused (JSON 500, PermissionError), a missing file's error as JSON; a
second server on svd_tiny.yaml answering img2vid with a GIF of its frames;
the sampling CLI writing a PNG equal to the API's.
"""

import io
import json
import re
import runpy
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from vidseg_diffusion_tpu_torch.inference.api import VideoSamplingParams
from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize_empty
from vidseg_diffusion_tpu_torch.scripts.demo import sampling as demo_cli
from vidseg_diffusion_tpu_torch.scripts.demo.serve import DemoApp, _PAGE, load_init, make_handler, to_uint8

SIZE = 64


@pytest.fixture(scope="module")
def init_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("init")
    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(root / "init.png")
    Image.fromarray(rs.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(root / "cond.png")
    return root


def _serve(app):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def sd(init_root):
    app = DemoApp("configs/inference/sd_tiny.yaml", default_size=SIZE, init_root=str(init_root), device="cpu")
    srv, url = _serve(app)
    yield app, url
    srv.shutdown()
    srv.server_close()


def _post(url, form, timeout=600):
    return urllib.request.urlopen(url + "/generate", data=urllib.parse.urlencode(form).encode(), timeout=timeout)


def _error(url, form):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, form, timeout=120)
    assert e.value.code == 500 and e.value.headers["Content-Type"] == "application/json"
    return json.loads(e.value.read())["error"]


def test_index_and_health(sd):
    app, url = sd
    assert app.device == torch.device("cpu") and app.dtype == torch.float32
    html = urllib.request.urlopen(url + "/").read().decode()
    fields = lambda page: sorted(set(re.findall(r'name="(\w+)"', page)))
    jax_page = runpy.run_path("scripts/demo/serve.py")["_PAGE"]
    assert fields(html) == fields(jax_page) == fields(_PAGE)
    assert "<form" in html and "EulerEDMSampler" in html
    assert json.loads(urllib.request.urlopen(url + "/health").read()) == {"ok": True}


def test_txt2img_png_equals_the_api(sd):
    app, url = sd
    resp = _post(url, {"prompt": "", "steps": 4, "scale": 5.0, "width": SIZE, "height": SIZE, "seed": 1,
                       "mode": "txt2img"})
    assert resp.headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(resp.read())))
    params = app.sampling_params({"steps": 4, "scale": 5.0, "width": SIZE, "height": SIZE})
    want = to_uint8(app.api.text_to_image(params, tokenize_empty(1), tokenize_empty(1),
                                          generator=torch.Generator().manual_seed(1))[0])
    assert got.shape == (SIZE, SIZE, 3) and got.std() > 0
    np.testing.assert_array_equal(got, want)


def test_img2img_png_equals_the_api(sd, init_root):
    app, url = sd
    form = {"prompt": "", "steps": 4, "width": SIZE, "height": SIZE, "init_path": "init.png", "strength": 0.5,
            "seed": 2}
    resp = _post(url, form)
    assert resp.headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(resp.read())))
    params = app.sampling_params(form)
    assert params.img2img_strength == 0.5
    want = to_uint8(app.api.image_to_image(params, load_init(str(init_root / "init.png"), SIZE, SIZE),
                                           tokenize_empty(1), tokenize_empty(1),
                                           generator=torch.Generator().manual_seed(2))[0])
    np.testing.assert_array_equal(got, want)


def test_init_path_outside_root_rejected(sd, tmp_path):
    _, url = sd
    outside = tmp_path / "esc.png"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(outside)
    for path in (str(outside), "../" + outside.name, "../../etc/passwd"):
        err = _error(url, {"prompt": "", "steps": 2, "width": SIZE, "height": SIZE, "init_path": path})
        assert err.startswith("PermissionError") and "escapes" in err


def test_errors_are_json(sd):
    _, url = sd
    assert _error(url, {"steps": 2, "init_path": "nonexistent/file.png"}).startswith("FileNotFoundError")
    assert _error(url, {"mode": "img2img", "steps": 2}).startswith("ValueError")
    assert _error(url, {"mode": "img2vid", "steps": 2, "init_path": "cond.png"})   # an SD config has no video


def test_img2vid_gif(init_root):
    app = DemoApp("configs/inference/svd_tiny.yaml", default_size=32, init_root=str(init_root), device="cpu")
    srv, url = _serve(app)
    try:
        form = {"mode": "img2vid", "steps": 2, "width": 32, "height": 32, "num_frames": 2, "init_path": "cond.png",
                "seed": 3}
        resp = _post(url, form)
        assert resp.headers["Content-Type"] == "image/gif"
        gif = Image.open(io.BytesIO(resp.read()))
        assert gif.size == (32, 32) and gif.n_frames == 2
        vparams = app.video_params(form)
        assert (vparams.num_frames, vparams.steps) == (2, 2) and isinstance(vparams, VideoSamplingParams)
    finally:
        srv.shutdown()
        srv.server_close()


def test_sampling_cli_writes_the_api_png(sd, tmp_path, capsys):
    app, _ = sd
    out = tmp_path / "out.png"
    demo_cli.main(["--mode", "txt2img", "--config", "configs/inference/sd_tiny.yaml", "--device", "cpu",
                   "--steps", "3", "--width", str(SIZE), "--height", str(SIZE), "--seed", "4", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "device: cpu" in printed and f"wrote {out}" in printed
    got = np.asarray(Image.open(out))
    params = app.sampling_params({"steps": 3, "width": SIZE, "height": SIZE, "scale": 5.0})
    want = to_uint8(app.api.text_to_image(params, tokenize_empty(1), generator=torch.Generator().manual_seed(4))[0])
    np.testing.assert_array_equal(got, want)
