"""Time the port's selective-scan kernels H (flat layout, segmented as
CD-Mamba's shipped route cuts them) and I (grouped layout, ChangeMamba's)
at three CD-Mamba and two ChangeMamba shapes, bf16: the forward,
checkpoint and backward sweeps, CUDA events over 5 calls after one
warm-up, in the checkout given as the first argument. To compare two
trees on one card, run it over both in turns in one command on the GPU
machine, e.g. with the parent commit unpacked under _scratch/parent:

    for t in _scratch/parent . . _scratch/parent; do python tools/torch_scan_sweeps_ab.py $t; done
"""
import os, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
import torch
from smow_net_tpu_torch.ops import _kernels, scan
_kernels.build(); _kernels.library()
dev = torch.device("cuda", 0)

def ms(fn, iters=5):
    fn(); torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters): fn()
    e.record(); torch.cuda.synchronize()
    return s.elapsed_time(e) / iters

g = torch.Generator(dev).manual_seed(0)
out = []
for (B, L, G, Cg, S) in ((32, 65536, 2, 32, 32), (32, 16384, 2, 64, 16), (32, 1024, 2, 256, 1)):
    Dch = G * Cg
    r = lambda *s: torch.randn(*s, device=dev, generator=g)
    args = [r(B, L, Dch).bfloat16(), r(B, L, Dch).bfloat16(), -torch.exp(r(Dch, 16) * 0.1),
            r(B, L, G, 16).bfloat16(), r(B, L, G, 16).bfloat16(), r(Dch), r(Dch) - 3]
    a = scan._Args(*args, flat=True)
    h0 = torch.rand(a.rows * S, 16, Cg, device=dev) if S > 1 else None
    gy = r(B, L, Dch).bfloat16()
    hck = scan._scan_ckpt(a, S, h0)
    out.append((f"H ({B*G},{L},{Cg}) S={S}", ms(lambda: scan._scan_fwd(a, S, h0)),
                ms(lambda: scan._scan_ckpt(a, S, h0)),
                ms(lambda: scan._scan_bwd(a, gy, hck, S, h0, h0))))
for shape in ((32, 4, 4096, 192), (16, 4, 8192, 256)):
    B, K, L, Dk = shape
    r = lambda *s: torch.randn(*s, device=dev, generator=g)
    args = [r(B, K, L, Dk).bfloat16(), r(B, K, L, Dk).bfloat16(), -torch.exp(r(K * Dk, 16) * 0.1),
            r(B, K, L, 16).bfloat16(), r(B, K, L, 16).bfloat16(), r(K * Dk), r(K * Dk) - 3]
    a = scan._Args(*args)
    gy = r(B, K, L, Dk).bfloat16()
    hck = scan._scan_ckpt(a)
    out.append((f"I {shape}", ms(lambda: scan._scan_fwd(a)), ms(lambda: scan._scan_ckpt(a)),
                ms(lambda: scan._scan_bwd(a, gy, hck))))
for name, f, c, b in out:
    print(f"{os.path.basename(os.path.normpath(tree))}: {name}: fwd {f:.4f} ckpt {c:.4f} "
          f"bwd {b:.4f} ms")
