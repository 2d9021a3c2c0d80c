"""How many bf16 parts the tensor-core flash kernel needs for P.

    PYTHONPATH=src python scripts/flash_p_rounding.py

The kernel of ``src/repro_torch/kernels/csrc/flash_attention.cu``
multiplies the softmax probabilities P by V on the tensor cores, which
take bf16.  This script emulates that product on the CPU in float64,
with P rounded to bf16 in 1, 2 or 3 parts (each part rounds what the
ones before left), normalised by the float32 row sum, rounded to bf16,
and counts the outputs that leave the bound the card's checks hold the
kernel to against the float32 plain version (``kernels/ref.attention``):
``|got - want| <= 2^-8 (|got| + |want|) + 1e-6``, one rounding of the
output.  Inputs are bf16 ``randn`` (seed 0), causal, GQA 4:1.
"""

import torch

from repro_torch.kernels import ref


def emulate(q, k, v, parts: int, window=None):
    """The kernel's arithmetic: P in ``parts`` bf16 parts, float64 sums."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1).double(), v.repeat_interleave(g, 1).double()
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) * D ** -0.5
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()
    l = p.double().sum(-1, keepdim=True)
    rest, p_parts = p, torch.zeros_like(p, dtype=torch.float64)
    for _ in range(parts):
        part = rest.bfloat16().float()
        p_parts += part.double()
        rest = rest - part
    return (torch.einsum("bhqk,bhkd->bhqd", p_parts, vr) / l).bfloat16()


def outside_bound(got, want) -> int:
    g, w = got.double(), want.double()
    return int(((g - w).abs() > 2.0 ** -8 * (g.abs() + w.abs()) + 1e-6).sum())


def main() -> None:
    gen = torch.Generator().manual_seed(0)
    print("shape (B, Hq, S, D), window | outputs | outside the bound with P in 1 / 2 / 3 "
          "bf16 parts")
    for B, Hq, S, D, window in [(2, 4, 300, 256, None), (2, 4, 300, 256, 64),
                                (1, 8, 130, 128, 7), (4, 4, 1024, 256, None)]:
        q, k, v = (torch.randn(B, h, S, D, generator=gen).bfloat16()
                   for h in (Hq, Hq // 4, Hq // 4))
        want = ref.attention(q, k, v, window=window)
        counts = [outside_bound(emulate(q, k, v, n, window), want) for n in (1, 2, 3)]
        print(f"{(B, Hq, S, D)}, {window} | {want.numel()} | "
              + " / ".join(str(c) for c in counts), flush=True)


if __name__ == "__main__":
    main()
