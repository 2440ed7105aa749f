"""Device time of K1 (flash_attention_packed) and K11 (matmul_bias) at the
main paths' shapes, beside the one PyTorch call for the same function, on
one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.time_kernels

Each call is captured 20 times into a CUDA graph and the replay is timed with
CUDA events, so the readings are device time without the host's launch cost
(chip_smoke.py's kernels phase times launches back to back from Python, and
below ~0.1 ms reads the host). Both kernels pick their shape from the
problem's (K11 a 192- or 128-row tile, K1 two warpgroups with 128-key tiles
for long key walks or one warpgroup with 64-key tiles); each case is timed
under that choice. Each output is also held to the plain version (bf16 steps
at max |plain|, relative RMS error; K1's LSE too). Prints the card's name and
power limit and ptxas's register / spill lines for the two kernels.
"""

import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# (M, K, N, bias): the projections of the SVD and SD 2.1 paths (ds1 to_q and
# to_out, ds2, ds4 to_out, mid; one-token and 77-token context products) and
# the wgmma kernel's edges
MM_SHAPES = [(163072, 320, 320, False), (163072, 320, 320, True), (40768, 640, 640, False),
             (10192, 1280, 1280, True), (2548, 1280, 1280, False), (28, 1024, 320, False),
             (2156, 1024, 320, False), (2156, 1024, 1280, False), (193, 320, 168, True)]
# (B, Lq, Lk, H): spatial self-attention per level (ds1 on a B = 2 slice and at
# the CFG batch of 28), the SD 2.1 cross-attention's 77 keys
ATTN_SHAPES = [(2, 5824, 5824, 5), (28, 5824, 5824, 5), (28, 1456, 1456, 10), (28, 364, 364, 20),
               (28, 91, 91, 20), (28, 5824, 77, 5), (28, 91, 77, 20)]


def graph_ms(torch, fn, n=20):
    """Device ms per call: n calls captured in one CUDA graph, one replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def errors(out, ref):
    """(bf16 steps at max |ref|, relative RMS error)"""
    diff = out.float() - ref.float()
    peak = ref.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(peak)) - 7)
    return diff.abs().max().item() / step, diff.norm().item() / ref.float().norm().item()


def main():
    import torch
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda.load_library()
    with open(os.path.join(_cuda.BUILD_DIR, "build.log")) as f:
        log = f.read().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and ("wgmma64" in line or "matmul_bias_wgmma" in line):
            print("ptxas:", line.split("for ")[-1], "|", " | ".join(s.strip() for s in log[i + 1:i + 3]))
        if "C7512" in line:
            print("ptxas:", line.strip())

    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf = torch.bfloat16
    for m, k, n, with_bias in MM_SHAPES:
        x, w = rn(m, k).to(bf), (rn(n, k) / k ** 0.5).to(bf)
        b = rn(n).to(bf) if with_bias else None
        ref = MM.matmul_bias_plain(x, w, b)
        lib_ms = graph_ms(torch, lambda: F.linear(x, w, b))
        steps, rms = errors(MM.matmul_bias(x, w, b), ref)
        ms = graph_ms(torch, lambda: MM.matmul_bias(x, w, b))
        print(f"K11 [{m},{k}->{n}]{' bias' if with_bias else ''}: {ms:.4f} ms (F.linear "
              f"{lib_ms:.4f}), {steps:.2f} bf16 steps, rel. RMS {rms:.2e}", flush=True)
        del x, w, b, ref
    for b, lq, lk, h in ATTN_SHAPES:
        q = rn(b, lq, h * 64).to(bf)
        k, v = (rn(b, lk, h * 64).to(bf) for _ in range(2))
        heads = lambda t: t.view(b, t.shape[1], h, 64).transpose(1, 2)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 5)
        # the plain version holds [B, H, Lq, Lk] fp32 logits: compared up to 2 GB of them
        ref = (A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
               if b * h * lq * lk * 4 <= 2e9 else None)
        out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
        check = ""
        if ref is not None:
            steps, rms = errors(out, ref[0])
            check = (f", {steps:.2f} bf16 steps, rel. RMS {rms:.2e}, LSE "
                     f"{(lse - ref[1]).abs().max().item():.2e}")
        ms = graph_ms(torch, lambda: A.flash_attention_packed(q, k, v, h), 5)
        print(f"K1 [{b},{lq}x{lk},{h}x64]: {ms:.4f} ms (SDPA {lib_ms:.4f}){check}", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
