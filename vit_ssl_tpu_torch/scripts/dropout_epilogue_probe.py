"""Probe: does applying the dropout mask inside the second FFN product
(kernel P2) beat dropout as plain passes on this card?

Port of ``scripts/dropout_epilogue_probe.py::main``. The FFN's d_ff-wide
dropout is the one dropout site next to a product, so the probe runs the
DINO student-globals FFN (T = 256·145 tokens, 384 → 1536, bf16, rate 0.1)
with the uint16-threshold keep-mask of ``ops/dropout.py`` five ways, each a
forward and a backward with every gradient (x, w1, b1, w2, b2) consumed:

- ``nodrop``: the FFN with no dropout (the floor);
- ``bitsonly``: no dropout, plus the keep-mask bits drawn and consumed
  (the cost of drawing them, apart from applying them);
- ``xla``: the FFN with ``dropout16`` as ``ops/feed_forward.py`` runs it
  (the name is the original's, so that the two scripts' lines compare);
- ``epilogue``: first product and GELU in PyTorch, then P2
  (:func:`..ops.masked_matmul.masked_matmul`);
- ``fused``: the whole FFN as kernel B4 (:func:`..ops.fused_mlp.fused_mlp`).

First the epilogue FFN is checked against the plain-PyTorch FFN on the same
mask (atol/rtol 5e-2 on o; atol 16, rtol 8e-2 on the gradients, as the
original: bf16 operands summed over 37k rows in other orders). Then each
leg is timed with CUDA events, in turns (each leg twice, the second pass
in reverse order), and the probe prints the original's derived lines and
the verdict of its retire rule: wire the epilogue into the FFN only if it
beats ``xla`` by at least 5 % at the FFN level and the gain survives at
the step level (which this probe does not measure). Run on a machine with
an NVIDIA GPU, from the root of a checkout:

    python -m vit_ssl_tpu_torch.scripts.dropout_epilogue_probe
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from vit_ssl_tpu_torch.scripts.exp2_probe import card_line, cuda_ms

RATE = 0.1
KEEP = 1.0 - RATE
T_ROWS, D_IN, D_FF = 256 * 145, 384, 1536  # DINO student-globals FFN
OUT_TOL = dict(atol=5e-2, rtol=5e-2)
GRAD_TOL = dict(atol=16.0, rtol=8e-2)
LEGS = ("nodrop", "bitsonly", "xla", "epilogue", "fused")
RETIRE_GAIN = 1.05  # epilogue must beat xla by this factor at the FFN level
ITERS = 30  # timed steps a leg, as the original's measure_steps


def ffn_xla(params, x, mask):
    """The port's FFN (``ops/feed_forward.py``), dropout as plain passes on
    the given keep-mask."""
    h = F.gelu(F.linear(x, params["w1"], params["b1"]))
    if mask is not None:
        h = torch.where(mask, h / KEEP, h.new_zeros(()))
    return F.linear(h, params["w2"], params["b2"])


def ffn_epilogue(params, x, mask):
    """First product and GELU in PyTorch, the masked second product as P2."""
    from vit_ssl_tpu_torch.ops.masked_matmul import masked_matmul

    h = F.gelu(F.linear(x, params["w1"], params["b1"]))
    return masked_matmul(h, mask, params["w2"], params["b2"], KEEP)


def ffn_fused(params, x, mask):
    from vit_ssl_tpu_torch.ops.fused_mlp import fused_mlp

    return fused_mlp(x, params["w1"], params["b1"], params["w2"], params["b2"], mask, KEEP)


def make_inputs():
    """x and the FFN's bf16 parameters (nn.Linear layout) on the card, as
    the original draws them: standard-normal x, weights ×0.05, zero
    biases."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    x = normal(T_ROWS, D_IN)
    params = {"w1": normal(D_FF, D_IN, scale=0.05),
              "b1": torch.zeros(D_FF, device="cuda", dtype=torch.bfloat16),
              "w2": normal(D_IN, D_FF, scale=0.05),
              "b2": torch.zeros(D_IN, device="cuda", dtype=torch.bfloat16)}
    return x, params


def _loss_and_grads(ffn, params, x, mask):
    leaves = [x.detach().requires_grad_(), *(p.detach().requires_grad_()
                                             for p in params.values())]
    out = ffn(dict(zip(params, leaves[1:])), leaves[0], mask)
    loss = out.float().sum()
    return out, loss, torch.autograd.grad(loss, leaves)


def check(x, params, generator):
    """The epilogue FFN against the plain FFN on one keep-mask: (max |o|
    difference, max |gradient| difference). Raises AssertionError outside
    the original's tolerances."""
    from vit_ssl_tpu_torch.ops.dropout import keep_mask16

    mask = keep_mask16((T_ROWS, D_FF), RATE, generator)
    out_a, _, grads_a = _loss_and_grads(ffn_epilogue, params, x, mask)
    out_b, _, grads_b = _loss_and_grads(ffn_xla, params, x, mask)
    torch.testing.assert_close(out_a.float(), out_b.float(), **OUT_TOL)
    for name, a, b in zip(("x", *params), grads_a, grads_b):
        torch.testing.assert_close(a.float(), b.float(), msg=f"d{name}", **GRAD_TOL)
    return (float((out_a.detach().float() - out_b.detach().float()).abs().max()),
            max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads_a, grads_b)))


def make_step(leg, params, x, generator):
    """One FFN step of a leg: the mask drawn (where the leg has one), a
    forward and a backward, every gradient reduced into the returned
    scalar."""
    from vit_ssl_tpu_torch.ops.dropout import keep_mask16

    ffn = {"epilogue": ffn_epilogue, "fused": ffn_fused}.get(leg, ffn_xla)
    with_mask = leg in ("xla", "epilogue", "fused")

    def step():
        mask = keep_mask16((T_ROWS, D_FF), RATE, generator) if with_mask else None
        _, val, grads = _loss_and_grads(ffn, params, x, mask)
        if leg == "bitsonly":  # draw and consume the bits without applying them
            val = val + keep_mask16((T_ROWS, D_FF), RATE, generator).float().sum()
        return val + sum(g.float().sum() for g in grads)

    return step


def probe():
    """The check, then each leg's mean ms per FFN step over ITERS steps,
    timed twice in turns (LEGS, then LEGS reversed). Returns {"out_err",
    "grad_err", "ms": {leg: (first, second)}}."""
    x, params = make_inputs()
    generator = torch.Generator(device="cuda").manual_seed(7)
    out_err, grad_err = check(x, params, generator)
    steps = {leg: make_step(leg, params, x, generator) for leg in LEGS}
    times = {leg: [] for leg in LEGS}
    for leg in LEGS + LEGS[::-1]:
        times[leg].append(cuda_ms(steps[leg], iters=ITERS))
    return {"out_err": out_err, "grad_err": grad_err,
            "ms": {leg: tuple(ms) for leg, ms in times.items()}}


def verdict(ms) -> str:
    """The retire rule's verdict on {leg: ms}."""
    gain = ms["xla"] / ms["epilogue"]
    if gain >= RETIRE_GAIN:
        return (f"epilogue beats xla by {gain:.3f}x (>= {RETIRE_GAIN}x) at the FFN "
                "level: wire it into FeedForwardBlock only if the gain survives at the "
                "step level, which this probe does not measure")
    return (f"retire: epilogue is {gain:.3f}x xla at the FFN level (needs >= "
            f"{RETIRE_GAIN}x); it stays out of FeedForwardBlock")


def report(result, card: str) -> None:
    """The original's lines: each leg, the derived costs, the verdict."""
    print(f"numerics OK (epilogue == the plain FFN on the same mask: o max_abs_err "
          f"{result['out_err']:.3e}, gradients {result['grad_err']:.3e})", flush=True)
    ms = {leg: min(pair) for leg, pair in result["ms"].items()}
    for leg in LEGS:
        first, second = result["ms"][leg]
        print(f"{leg:<8} {ms[leg]:8.3f} ms/FFN-step ({first:.3f} / {second:.3f}; "
              f"bf16, T={T_ROWS}, {D_IN}->{D_FF}, on {card})", flush=True)
    base = ms["xla"]
    print(f"bits generation cost: {ms['bitsonly'] - ms['nodrop']:.3f} ms", flush=True)
    print(f"mask application cost in the plain passes: {base - ms['bitsonly']:.3f} ms",
          flush=True)
    print(f"epilogue vs xla: {base / ms['epilogue']:.3f}x "
          f"({base - ms['epilogue']:+.3f} ms)", flush=True)
    print(f"fused vs xla: {base / ms['fused']:.3f}x", flush=True)
    print(f"verdict: {verdict(ms)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dropout_epilogue_probe: no CUDA device; this probe runs on the card",
              file=sys.stderr)
        return 1
    report(probe(), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
