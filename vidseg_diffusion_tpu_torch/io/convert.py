"""JAX parameter trees -> the port's state dicts (pure numpy).

The port's modules carry the reference's sgm / open_clip state-dict key
names, the names the JAX package's io/checkpoint.py key functions map its
flax paths to. This module holds those key functions (unet, image or video;
vae, image or video decoder; clip vision; clip text: the same rules, without
the JAX package's jax imports; the VAE's also names the VideoAttnBlock's
parameters as the reference does, which the JAX package's does not) and
turns a flax parameter tree (nested dicts of numpy arrays) into a state dict
for the port. The autoencoder-training losses (LPIPS with its VGG16 trunk,
the PatchGAN discriminator) keep the flax module names, so their key
function only joins the path:

    Dense kernel [in, out]                  -> Linear weight [out, in]
    Conv kernel HWIO [kh, kw, in, out]      -> Conv2d weight OIHW
    3-D kernel [kt, kh, kw, in, out]        -> Conv3d weight [out, in, kt, kh, kw]
    scale / bias / mix_factor / embeddings  -> unchanged

It is the inverse of the JAX package's convert_state_dict(_adapt): running
that on the result gives back the tree. `split_packed_qkv` serves loading
open_clip checkpoints, whose attention stores q/k/v as one in_proj.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import numpy as np

Path = Tuple[str, ...]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mix_factor": "mix_factor", "embedding": "weight"}

_RESBLOCK = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb_proj": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip": "skip_connection",
}
_RESBLOCK_NO_EMB = {k: v for k, v in _RESBLOCK.items() if k not in ("emb_proj", "skip")}


def _seq(name: str) -> str:
    return re.sub(r"_(\d+)", r".\1", name)


def unet_key_fn(path: Path) -> str:
    """flax path -> sgm key of the UNet, image or video."""
    parts = [p for p in path[:-1] if p != "gn"]
    leaf = path[-1]
    segs = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p.startswith("label_emb"):
            segs.append(f"label_emb.0.{p.split('_')[-1]}")
        elif p in _RESBLOCK and "time_stack" not in segs[-1:]:
            segs.append(_RESBLOCK[p])
        elif p == "spatial":
            pass
        elif p == "time_stack" and i + 1 < len(parts) and parts[i + 1] in _RESBLOCK:
            segs += ["time_stack", _RESBLOCK[parts[i + 1]]]
            i += 1
        elif p == "to_out":
            segs.append("to_out.0")
        elif p == "net_in":
            segs.append("net.0")
        elif p == "net_out":
            segs.append("net.2")
        elif p == "proj" and segs and segs[-1].endswith("net.0"):
            segs.append("proj")
        else:
            segs.append(_seq(p))
        i += 1
    segs.append(_LEAF[leaf])
    return ".".join(segs)


# inside the VideoDecoder's VideoAttnBlock (mid.attn_1): its transformer
# block's FeedForward / to_out and the frame embedding's Linear layers, under
# the reference's sequential indices (the JAX package's own vae_key_fn keeps
# the flax names there)
_VAE_TIME_MIX = {"to_out": "to_out.0", "net_in": "net.0", "net_out": "net.2",
                 "video_time_embed_0": "video_time_embed.0", "video_time_embed_2": "video_time_embed.2"}


def vae_key_fn(path: Path) -> str:
    """flax path -> sgm key of the VAE encoder / (video) decoder."""
    parts = [p for p in path[:-1] if p != "gn"]
    leaf = path[-1]
    segs = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.match(r"(down|up)_(\d+)_block_(\d+)", p)
        m2 = re.match(r"(down|up)_(\d+)_(downsample|upsample)", p)
        m3 = re.match(r"mid_(block_[12]|attn_1)", p)
        if m:
            segs.append(f"{m.group(1)}.{m.group(2)}.block.{m.group(3)}")
        elif m2:
            segs.append(f"{m2.group(1)}.{m2.group(2)}.{m2.group(3)}")
        elif m3:
            segs.append(f"mid.{m3.group(1)}")
        elif p == "spatial":
            pass
        elif p == "time_stack" and i + 1 < len(parts) and parts[i + 1] in _RESBLOCK_NO_EMB:
            segs += ["time_stack", _RESBLOCK_NO_EMB[parts[i + 1]]]
            i += 1
        elif p == "conv_out_time_mix":
            segs.append("conv_out.time_mix_conv")
        elif p in _VAE_TIME_MIX:
            segs.append(_VAE_TIME_MIX[p])
        else:
            segs.append(p)
        i += 1
    segs.append(_LEAF[leaf])
    return ".".join(segs)


def clip_text_key_fn(path: Path) -> str:
    """flax path -> open_clip key of the text tower."""
    if path[-1] == "token_embedding":
        return "token_embedding.weight"
    return clip_vision_key_fn(path)[len("visual."):]


def clip_vision_key_fn(path: Path) -> str:
    """flax path -> open_clip key of the vision tower ('visual.' prefix)."""
    parts = list(path[:-1])
    leaf = path[-1]
    segs = []
    for p in parts:
        if p.startswith("resblocks_"):
            segs.append("transformer." + p.replace("resblocks_", "resblocks."))
        elif p.startswith("attn_"):
            segs.append("attn." + p.split("_", 1)[1])
        elif p.startswith("mlp_"):
            segs.append("mlp." + p.split("_", 1)[1])
        else:
            segs.append(p)
    if leaf in ("positional_embedding", "class_embedding", "proj"):
        return "visual." + ".".join(segs + [leaf])
    return "visual." + ".".join(segs + [{"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]])


def autoencoder_loss_key_fn(path: Path) -> str:
    """flax path -> key of the port's LPIPS (vgg.conv_{i}, lin_{i}) or
    NLayerDiscriminator (conv0, conv{i}, norm{i}, conv_out)."""
    return ".".join(path[:-1] + (_LEAF[path[-1]],))


def _flatten(tree: Dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def to_torch_layout(w: np.ndarray, leaf: str) -> np.ndarray:
    """One flax leaf in the torch module's layout."""
    if leaf != "kernel":
        return w
    if w.ndim == 2:
        return w.T
    if w.ndim == 4:
        return w.transpose(3, 2, 0, 1)
    if w.ndim == 5:
        return w.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"no torch layout for a {w.ndim}-D kernel")


def jax_to_state_dict(params: Dict, key_fn: Callable[[Path], str],
                      strip_prefix: str = "") -> Dict[str, np.ndarray]:
    """flax tree (nested dicts of arrays) -> {state-dict key: array}.
    `strip_prefix` drops a leading key prefix (e.g. 'visual.')."""
    sd = {}
    for path, val in _flatten(params).items():
        key = key_fn(path)
        if strip_prefix:
            if not key.startswith(strip_prefix):
                raise KeyError(f"{key} lacks prefix {strip_prefix}")
            key = key[len(strip_prefix):]
        if key in sd:
            raise KeyError(f"two flax paths map to {key}")
        sd[key] = np.ascontiguousarray(to_torch_layout(np.asarray(val), path[-1]))
    return sd


def split_packed_qkv(sd: Dict) -> Dict:
    """open_clip attention: in_proj_weight [3W, W] / in_proj_bias [3W] ->
    attn.q/k/v, out_proj -> attn.out (works on numpy arrays and tensors)."""
    out = dict(sd)
    for k in list(sd):
        for suffix, leaf in (("attn.in_proj_weight", "weight"), ("attn.in_proj_bias", "bias")):
            if k.endswith(suffix):
                w = sd[k]
                n = w.shape[0] // 3
                base = k[: -len(suffix)] + "attn."
                for i, name in enumerate("qkv"):
                    out[f"{base}{name}.{leaf}"] = w[i * n:(i + 1) * n]
                del out[k]
        if ".attn.out_proj." in k:
            out[k.replace(".attn.out_proj.", ".attn.out.")] = sd[k]
            del out[k]
    return out
