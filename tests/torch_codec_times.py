"""The spill codec's page path timed on the card, in the checkout it runs
from (its ``src/`` and ``chip_smoke.py``), so that two checkouts can be
compared on one card:

    cd CHECKOUT && python3 /path/to/tests/torch_codec_times.py

``chip_ab.sh DIR_A DIR_B codec`` runs it in both, A B B A.  For full-width
smollm-135m and zamba2-2.7b pages (bfloat16 pools as the serving path
allocates them) it times the page path leaf by leaf (a clone of each leaf,
then the int8 pack; the unpack of each leaf, then a copy into the frame),
one leaf's pack and unpack alone, and, where the checkout has them, the
one-launch page pack and unpack and the same page through the pack's
two-pass regime; then the int8 pack and the fp8 unpack of 8192 x 576.
Device ms: calls captured in a CUDA graph (``chip_smoke.device_ms``);
eager ms: one call from Python.
"""
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(0, os.getcwd())

import chip_smoke as c                                     # noqa: E402
from repro_torch import tree                               # noqa: E402
from repro_torch.configs import ARCHS                      # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels import offload_pack as kp         # noqa: E402
from repro_torch.models import transformer as tfm          # noqa: E402


def row(label, fn):
    print(f"  {label}: {c.device_ms(fn):.5f} ms device, "
          f"{c.eager_ms(fn):.5f} ms eager", flush=True)


def two_pass(frame):
    """The page's int8 pack forced through the two-pass regime."""
    fn = build.function("offload_pack", "int8_pack_leaves",
                        kp._PACK_LEAVES_ARGS)
    dev = frame[0].device
    scales = torch.empty(len(frame), device=dev)
    qs = [torch.empty(x.shape, dtype=torch.int8, device=dev) for x in frame]
    descs = (kp._Leaf * len(frame))(*[
        kp._leaf("two_pass", x, q, scales.data_ptr() + 4 * i, x.numel())
        for i, (x, q) in enumerate(zip(frame, qs))])
    slices = -(-(frame[0].numel() // kp.VEC) // (kp.PASS_THREADS * kp.BATCH))
    partials = torch.empty(len(frame) * slices, device=dev)

    def go():
        kp._check(fn(1, len(frame), ctypes.addressof(descs), 0, slices,
                     partials.data_ptr(),
                     torch.cuda.current_stream().cuda_stream), "two_pass")
    return go


def main():
    dev = torch.device("cuda")
    for arch, num in (("smollm-135m", 64), ("zamba2-2.7b", 96)):
        pool, _ = tfm.paged_pool(ARCHS[arch], num, 16, torch.bfloat16, dev)
        for leaf in tree.leaves(pool):
            leaf.normal_()
        frame = [leaf[:, 5] for leaf in tree.leaves(pool)]

        def per_leaf_pack():
            return [kp.int8_pack(x.clone().reshape(-1, x.shape[-1]),
                                 block_rows=x.numel() // x.shape[-1])
                    for x in frame]

        coded = per_leaf_pack()

        def per_leaf_unpack():
            for (q, s), x in zip(coded, frame):
                x.copy_(kp.fp8_unpack(q, s, block_rows=q.shape[0])
                        .reshape(x.shape))

        row(f"{arch} page pack, leaf by leaf", per_leaf_pack)
        row(f"{arch} page unpack, leaf by leaf", per_leaf_unpack)
        leaf = frame[0].clone().reshape(-1, frame[0].shape[-1])
        q0, s0 = coded[0]
        row(f"{arch} one leaf's pack",
            lambda: kp.int8_pack(leaf, block_rows=leaf.shape[0]))
        row(f"{arch} one leaf's unpack",
            lambda: kp.fp8_unpack(q0, s0, block_rows=q0.shape[0]))
        if hasattr(kp, "int8_pack_leaves"):
            qs = [q.reshape(x.shape) for (q, _), x in zip(coded, frame)]
            ss = [s.reshape(()) for _, s in coded]
            row(f"{arch} page pack, one launch",
                lambda: kp.int8_pack_leaves(frame))
            row(f"{arch} page pack, two passes", two_pass(frame))
            row(f"{arch} page unpack, one launch",
                lambda: kp.unpack_leaves(qs, ss, frame))
    x = c.codec_case(dev, torch.bfloat16, 8192, 576, seed=5)
    row("int8 pack 8192 x 576", lambda: kp.int8_pack(x, block_rows=8192))
    q, s = kp.fp8_pack(x, block_rows=8192)
    row("unpack 8192 x 576 fp8", lambda: kp.fp8_unpack(q, s,
                                                        block_rows=8192))


if __name__ == "__main__":
    main()
