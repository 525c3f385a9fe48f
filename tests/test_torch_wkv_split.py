"""The accuracy of K5's tensor-core arithmetic, on the CPU.

The WKV kernel (csrc/rwkv6_wkv.cu) runs its four chunk products — att =
(r·D₋)(k/D)^T, att·v, (r·D₋)·S_in and the state's increment (k/D)^T v —
as TF32 tensor-core MMAs with float32 accumulators, each float32 operand
split as x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and a·b
taken as hi·hi' + hi·lo' + lo·hi' (3×TF32).  A bfloat16 operand is exact
in TF32, so where v is bfloat16 att·v and the increment need 2 products.
No card is needed to see whether that keeps float32 accuracy: this file
emulates the kernel's chunk step in plain PyTorch (operands rounded as
``cvt.rna.tf32.f32`` rounds, products formed as the kernel forms them,
sums in float32) and holds it against the plain version rwkv6_wkv_ref
within chip_smoke.py's WKV_TOL, the limit the card is held to.  Single
TF32 (one product of the rounded operands) is computed beside it and
printed: it keeps about three decimal digits.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import WKV_EPS, rwkv6_wkv_ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)
WKV_TOL = _cs.WKV_TOL  # (max|d| / max|ref|, ||d|| / ||ref||)

SWEEP = ((32, 8, 8), (64, 16, 16), (128, 64, 64), (64, 32, 64))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: to 10 mantissa
    bits, ties away from zero (the 13 low bits of the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, *, b_exact: bool, passes: int) -> torch.Tensor:
    """a @ b as the kernel's MMAs form it: 3 products (hi·hi', hi·lo',
    lo·hi'), 2 where b is exact in TF32 (a bfloat16 operand), or, with
    passes 1, single TF32."""
    a_hi, a_lo = split(a)
    if passes == 1:
        return a_hi @ (b if b_exact else tf32(b))
    if b_exact:
        return a_hi @ b + a_lo @ b
    b_hi, b_lo = split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def warp_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over dim 1 in the kernel's order: a
    Hillis-Steele scan over each half of 32 steps (one lane per step), the
    second half then offset by the first half's total."""
    halves = []
    for y in x.split(32, dim=1):
        for o in (1, 2, 4, 8, 16):
            z = y.clone()
            z[:, o:] += y[:, :-o]
            y = z
        if halves:
            y = y + halves[-1][:, -1:]
        halves.append(y)
    return torch.cat(halves, dim=1)


def emulate(r, k, v, w, u, *, chunk: int, passes: int = 3) -> torch.Tensor:
    """The kernel's chunk loop on [BH, L, N] inputs and u [BH, N]: the
    decays of the reference's chunk form (the cumulative sum in the
    kernel's scan order), att = (r·D₋)(k/D)^T strictly below the
    diagonal, o = att·v + diag(r·u·k)·v + (r·D₋)·S, and S = a_c ⊙ (S +
    (k/D)^T v) (the kernel adds the increment onto S and scales the sum's
    rows by a_c).  v bfloat16 counts as exact."""
    bh, l, n = r.shape
    c = min(chunk, l)
    v_exact = v.dtype == torch.bfloat16
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    s = torch.zeros((bh, n, n))
    tri = torch.tril(torch.ones(c, c), diagonal=-1)
    out = []
    for t0 in range(0, l, c):
        rc, kc, vc = r[:, t0:t0 + c], k[:, t0:t0 + c], v[:, t0:t0 + c]
        lw = torch.log(torch.clamp(w[:, t0:t0 + c], WKV_EPS, 1.0))
        log_d = warp_cumsum(lw)
        d = torch.exp(log_d)
        r_sc = rc * torch.exp(log_d - lw)
        k_sc = kc / d
        a_c = d[:, -1]
        att = mm(r_sc, k_sc.transpose(1, 2), b_exact=False, passes=passes) * tri
        diag = (rc * u[:, None] * kc).sum(-1, keepdim=True)
        o = (mm(att, vc, b_exact=v_exact, passes=passes) + diag * vc
             + mm(r_sc, s, b_exact=False, passes=passes))
        out.append(o)
        inc = mm(k_sc.transpose(1, 2), vc, b_exact=v_exact, passes=passes)
        s = a_c[:, :, None] * (s + inc)
    return torch.cat(out, dim=1)


def inputs(seed, shape, decays, dtype):
    """r, k, v ~ N(0, 1), u ~ N(0, 0.1²); decays the reference test's
    (sigmoid(N(0, 1)) / 2 + 1/2, in [0.5, 1]) or the model's
    (exp(-exp(U[-6, -1])), in [0.69, 0.998]).  ``dtype`` "model" is the
    model's mix: r, k, v, u bfloat16 and w float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if decays == "reference":
        w = 0.5 / (1.0 + np.exp(-rng.standard_normal(shape))) + 0.5
    else:
        w = np.exp(-np.exp(rng.uniform(-6.0, -1.0, shape)))
    u = rng.standard_normal((shape[0], shape[-1])) * 0.1
    ts = [torch.from_numpy(np.asarray(t, np.float32)) for t in (r, k, v, w, u)]
    if dtype == "model":
        ts = [t if i == 3 else t.to(torch.bfloat16) for i, t in enumerate(ts)]
    return ts


def errors(got, want) -> tuple[float, float]:
    d = got - want
    return (float(d.abs().max() / want.abs().max()),
            float(d.norm() / want.norm()))


@pytest.mark.parametrize("dtype", ["float32", "model"])
@pytest.mark.parametrize("decays", ["reference", "model"])
@pytest.mark.parametrize("l,n,chunk", SWEEP)
def test_split_tf32_holds_wkv_tol(l, n, chunk, decays, dtype):
    """3×TF32 (2 products where v is bfloat16) stays within WKV_TOL of the
    float32 plain version on the reference sweep, at both decay ranges;
    single TF32's error is printed beside it."""
    args = inputs(l * 100 + n + chunk, (3, l, n), decays, dtype)
    want = rwkv6_wkv_ref(*args, chunk=chunk)
    e3 = errors(emulate(*args, chunk=chunk), want)
    e1 = errors(emulate(*args, chunk=chunk, passes=1), want)
    print(f"wkv split (L, N, chunk) {(l, n, chunk)} decays {decays} {dtype}: "
          f"3xTF32 max|d|/max|ref| {e3[0]:.2e}, |d|/|ref| {e3[1]:.2e}; "
          f"single TF32 {e1[0]:.2e}, {e1[1]:.2e} (WKV_TOL {WKV_TOL})")
    assert e3[0] <= WKV_TOL[0] and e3[1] <= WKV_TOL[1]


def test_tf32_rounds_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits and rounds a tie away from zero."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -20, 3.0 + 2.0 ** -12],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0]
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)  # these x need no more than 2 x 11 bits
