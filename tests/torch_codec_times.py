"""The spill / stash codec timed on the card, in the checkout it runs from
(its ``src/`` and ``chip_smoke.py``), so that two checkouts can be
compared on one card:

    cd CHECKOUT && python3 /path/to/tests/torch_codec_times.py

``chip_ab.sh DIR_A DIR_B codec`` runs it in both, A B B A.  For full-width
smollm-135m and zamba2-2.7b pages (bfloat16 pools as the serving path
allocates them) it times the int8 page path leaf by leaf (a clone of each
leaf, then the int8 pack; the unpack of each leaf, then a copy into the
frame), one leaf's pack and unpack alone, and, where the checkout has
them, each codec's one-launch page pack (fp8 and blocksparse only where
the checkout packs their pages in one launch), the int8 page through the
pack's two-pass regime, and the one-launch page unpack.  Then each pack
on stashed tensors, each one row block: bfloat16 8192 x 576 of
``codec_case`` (the fp8 scale 1), of randn values (a scale that is no
power of two) and of randn values with an absmax that makes exact fp8
ties common; randn at 8192 x 1024; and the layer inputs that one training
step of full-width smollm-135m (30 of 8192 x 576) and mamba2-370m (48 of
8192 x 1024) stashes.  Each set reports what the fp8 pack's guard meets
(power-of-two scales, chunks near an e4m3 midpoint, values divided) and
each pack's time a tensor (one CUDA graph packs a set in turn: the
captured sets are read from HBM, a single tensor from L2).  Last the fp8
unpack of 8192 x 576.  Device ms:
calls captured in a CUDA graph (``chip_smoke.device_ms``); eager ms: one
call from Python.
"""
import ctypes
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(0, os.getcwd())

import chip_smoke as c                                     # noqa: E402
from repro_torch import tree                               # noqa: E402
from repro_torch.configs import ARCHS                      # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels import offload_pack as kp         # noqa: E402
from repro_torch.kernels import ref                        # noqa: E402
from repro_torch.models import transformer as tfm          # noqa: E402


def row(label, fn):
    print(f"  {label}: {c.device_ms(fn):.5f} ms device, "
          f"{c.eager_ms(fn):.5f} ms eager", flush=True)


def two_pass(xs):
    """The int8 pack of the leaves ``xs`` (each one row block) forced
    through the two-pass regime, through the checkout's C entry:
    ``pack_leaves`` with the quantiser first, or the int8-only
    ``int8_pack_leaves`` before it."""
    one_family = hasattr(kp, "_pack_launch")
    fn = build.function("offload_pack", "pack_leaves" if one_family
                        else "int8_pack_leaves", kp._PACK_LEAVES_ARGS)
    dev = xs[0].device
    scales = torch.empty(len(xs), device=dev)
    qs = [torch.empty(x.shape, dtype=torch.int8, device=dev) for x in xs]
    descs = (kp._Leaf * len(xs))(*[
        kp._leaf("two_pass", x, q, scales.data_ptr() + 4 * i, x.numel())
        for i, (x, q) in enumerate(zip(xs, qs))])
    slices = -(-(xs[0].numel() // kp.VEC) // (kp.PASS_THREADS * kp.BATCH))
    partials = torch.empty(len(xs) * slices, device=dev)
    head = (0, 1) if one_family else (1,)      # int8, bfloat16

    def go(keep=(qs, scales)):       # the outputs live as long as the call
        kp._check(fn(*head, len(xs), ctypes.addressof(descs), 0, slices,
                     partials.data_ptr(),
                     torch.cuda.current_stream().cuda_stream), "two_pass")
    return go


def fp8_guard_shares(xs):
    """What the fp8 pack's guard meets on the tensors ``xs``, each packed
    as one row block: the share of them whose scale is a power of two (the
    product x * (1/s) then is the quotient), the share of their 16-element
    chunks that take the slow path (a value within 8 ulps of an e4m3
    midpoint, exact ties included: ``near_midpoint`` of
    csrc/offload_pack.cu) and the share of their values that divide there
    (near a midpoint and not on it)."""
    pow2 = slow = chunks = div = vals = 0
    for x in xs:
        xf = x.float().reshape(-1)
        s = torch.clamp(ref.true_div(xf.abs().amax(), 448.0), min=1e-12)
        pow2 += (int(s.view(torch.int32)) & 0x7FFFFF) == 0
        p = (xf * (torch.ones_like(s) / s)).abs()
        sub = p < 2.0 ** -6
        bits = torch.where(sub, p + 2.0 ** -6, p).view(torch.int32)
        near = ((bits & 0xFFFFF) - 0x80000).abs() < 8
        m = ((bits & ~0xFFFFF) | 0x80000).view(torch.float32)
        m = torch.where(sub, m - 2.0 ** -6, m)
        tie = xf.abs().double() == m.double() * s.double()
        slow += int(near.reshape(-1, 16).any(1).sum())
        chunks += xf.numel() // 16
        div += int((near & ~tie).sum())
        vals += xf.numel()
    return pow2 / len(xs), slow / chunks, div / vals


def captured_stash(arch):
    """The layer inputs one full-width training step of ``arch`` stashes
    (8 x 1024 tokens, random weights from seed 0, the fp8 codec to host
    memory, as chip_smoke.py's phases 5 and 7 train), copied as the stash
    is called."""
    from repro_torch.core import tiers
    from repro_torch.launch import train as train_cli
    got, encode = [], tiers.encode_tensor

    def spy(codec, x):
        got.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return encode(codec, x)

    tiers.encode_tensor = spy
    try:
        with tempfile.TemporaryDirectory(prefix="codec_times_ckpt_") as d:
            train_cli.main(["--arch", arch, "--device", "cuda", "--seed",
                            "0", "--batch", "8", "--seq", "1024", "--steps",
                            "1", "--lr", "3e-4", "--policy", "host",
                            "--compress", "fp8", "--log-every", "1",
                            "--ckpt-dir", d])
    finally:
        tiers.encode_tensor = encode
    torch.cuda.synchronize()
    return got


def stash_rows(tag, xs):
    """Each pack over the tensors ``xs`` (each one row block), ms a tensor
    on the device.  One CUDA graph packs them all in turn, so a set larger
    than the L2 is read from HBM."""
    rc = f"{xs[0].shape[0]} x {xs[0].shape[1]}"
    pow2, slow, div = fp8_guard_shares(xs)
    print(f"  {tag} {rc} ({len(xs)} tensors): fp8 scales a power of two "
          f"{pow2:.4f}; fp8 chunks near a midpoint {slow:.5f}, values "
          f"divided {div:.2e}", flush=True)
    for name in ("fp8_pack", "int8_pack", "blocksparse_pack"):
        pack = getattr(kp, name)

        def all_():
            for x in xs:
                pack(x, block_rows=x.shape[0])
        ms = c.device_ms(all_, iters=max(1, 100 // len(xs))) / len(xs)
        print(f"  {name} {tag} {rc}: {ms:.5f} ms device a tensor",
              flush=True)


def main():
    dev = torch.device("cuda")
    build.build()                    # every kernel, in parallel
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
        for name in ("fp8_pack", "int8_pack", "blocksparse_pack"):
            pack = getattr(kp, name)
            row(f"{arch} one leaf's {name}",
                lambda: pack(leaf, block_rows=leaf.shape[0]))
        row(f"{arch} one leaf's unpack",
            lambda: kp.fp8_unpack(q0, s0, block_rows=q0.shape[0]))
        if hasattr(kp, "int8_pack_leaves"):
            qs = [q.reshape(x.shape) for (q, _), x in zip(coded, frame)]
            ss = [s.reshape(()) for _, s in coded]
            for name in ("fp8_pack", "int8_pack", "blocksparse_pack"):
                if hasattr(kp, name + "_leaves"):
                    row(f"{arch} page {name}, one launch",
                        lambda: getattr(kp, name + "_leaves")(frame))
            row(f"{arch} page int8_pack, two passes", two_pass(frame))
            row(f"{arch} page unpack, one launch",
                lambda: kp.unpack_leaves(qs, ss, frame))
    for rc, data in (((8192, 576), "codec_case"), ((8192, 576), "randn"),
                     ((8192, 1024), "randn"), ((8192, 576), "randn_ties")):
        # codec_case: absmax 448 (the fp8 scale 1: one bf16 value in 16
        # lies on an e4m3 midpoint); randn: a scale that is no power of
        # two; randn_ties: its absmax set to 15.25 (61 / 4), where bf16
        # values such as 61 x 3 x 2^k (15.25 x 3/16 x 2^j) are exact fp8
        # ties
        if data == "codec_case":
            x = c.codec_case(dev, torch.bfloat16, *rc, seed=5)
        else:
            g = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn(rc, generator=g, device=dev) * 3
            if data == "randn_ties":
                x = x.clamp(-15, 15)
                x[0, 0] = 15.25
            x = x.to(torch.bfloat16)
        stash_rows(data, [x])
    for arch in ("smollm", "mamba2-370m"):
        xs = captured_stash(arch)
        stash_rows(f"{arch} stash", xs)
        del xs
    x = c.codec_case(dev, torch.bfloat16, 8192, 576, seed=5)
    q, s = kp.fp8_pack(x, block_rows=8192)
    row("unpack 8192 x 576 fp8", lambda: kp.fp8_unpack(q, s,
                                                        block_rows=8192))


if __name__ == "__main__":
    main()
