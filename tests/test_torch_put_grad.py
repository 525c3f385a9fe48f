"""The gradient of a channel put (comm/grad.py ``Put``) on the CPU.

* The gradient of a put is the put of the cotangents along the inverse
  route, through the same lowering: for a wrapping rotation on both
  backends ("xla", and "pallas" on a two-axis route (K4) and a one-axis
  route with ``interpret=False`` (K3); on the CPU their plain versions),
  for ``models/ssm.py:shift_ranks`` (no wraparound: the dropped
  deliveries get zeros), and for the staged, hierarchical and monolithic
  all-to-alls and their inverses (each the other's transpose, since they
  only route).  Every backward put is recorded: the same axes, backend
  and ``interpret`` as its forward put, and the inverse permutation.
* The forward's outputs are bitwise those of the same put without a
  gradient; under ``torch.no_grad()`` nothing is wrapped; a put with an
  fp8 wire refuses a gradient.
* The negative control: detaching the puts' outputs (what the put kernels
  gave before the put had a gradient) breaks reduced rwkv6's gradient
  over (pod 2, model 2) against its degree 1.
"""
import dataclasses

import pytest
import torch

from repro_torch.comm import grad as put_grad
from repro_torch.comm.channel import Channel
from repro_torch.comm.stream import (hier_all_to_all, hier_ungroup,
                                     staged_all_to_all, staged_ungroup)
from repro_torch.core.collectives import (GroupLayout, monolithic_all_to_all,
                                          ungroup_all_to_all)
from repro_torch.models import ssm
from test_torch_train_sp import _one_thread
from test_torch_train_sp_state import (SELF_BOUND, _case_inputs, _cfgs,
                                       grad_gap, port_loss_and_grads)

assert _one_thread  # the module-level one-thread fixture, used here too
AXES2 = ("pod", "model")
# (axes, backend, interpret): xla; K4 on two axes; K3 on one axis
ROUTES = {"xla": (AXES2, "xla", True), "k4": (AXES2, "pallas", True),
          "k3": (("model",), "pallas", False)}


def _ranks(n, shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for _ in range(n)]


@pytest.fixture
def puts(monkeypatch):
    """Every put issued, as (axes, perm, backend, interpret, whether it is
    a backward put)."""
    log, real = [], Channel._put

    def recording(self, tensors, overlaps):
        log.append((self.axes, self.perm, self.backend, self.interpret,
                    self.name.endswith(".grad")))
        return real(self, tensors, overlaps)

    monkeypatch.setattr(Channel, "_put", recording)
    return log


def _vjp(fn, xs, cots):
    """(fn's outputs without a gradient, with one, and the gradient of
    sum <out, cot> in every input rank list)."""
    with torch.no_grad():
        plain = fn(*xs)
    ins = [[t.clone().requires_grad_() for t in x] for x in xs]
    out = fn(*ins)
    outs = [t for o in out for t in o] if isinstance(out, tuple) else out
    cts = [t for c in cots for t in c] if isinstance(out, tuple) else cots
    grads = torch.autograd.grad(outs, [t for x in ins for t in x], cts,
                                allow_unused=True)
    return plain, out, grads


def _bitwise(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(map(_bitwise, a, b))


@pytest.mark.parametrize("route", list(ROUTES))
def test_rotation_gradient_is_the_inverse_put(route, puts):
    axes, backend, interpret = ROUTES[route]
    ch = Channel(axes=axes, perm=tuple((r, (r + 1) % 4) for r in range(4)),
                 backend=backend, interpret=interpret)
    xs = [_ranks(4, (2, 3, 5), 0), _ranks(4, (7,), 1)]
    cots = [_ranks(4, (2, 3, 5), 2), _ranks(4, (7,), 3)]
    plain, out, grads = _vjp(lambda a, b: ch.put(a, b).wait(), xs, cots)
    assert _bitwise(plain, out)  # the forward is the put without a gradient
    assert all(t.grad_fn is not None for o in out for t in o)
    back = dataclasses.replace(ch, perm=put_grad.inverse_perm(ch.perm))
    with torch.no_grad():
        want = back.put(*cots).wait()
    assert _bitwise(list(grads), [t for w in want for t in w])
    for s in range(4):  # rank s's gradient is its receiver's cotangent
        assert torch.equal(grads[s], cots[0][(s + 1) % 4])
    # the plain put, the put with a gradient, its backward, the check's
    assert puts[:3] == [(axes, ch.perm, backend, interpret, False)] * 2 + [
        (axes, back.perm, backend, interpret, True)]


@pytest.mark.parametrize("d", [1, 2])
def test_shift_without_wraparound_gradient(d, puts):
    """Rank p receives rank p - d's tensor (ranks below d: None); the
    gradient of rank p's tensor is rank p + d's cotangent, zero where the
    delivery was dropped.  Two batch slices of 4 SP ranks."""
    size, slices = 4, 2
    xs = [_ranks(size * slices, (3, 2), 4)]
    cots = _ranks(size * slices, (3, 2), 5)

    def shifted(x):
        (recv,) = ssm.shift_ranks((x,), AXES2, size, d, slices)
        return [r for r in recv if r is not None]

    plain, out, grads = _vjp(shifted, xs, [c for p, c in enumerate(cots)
                                           if p % size >= d])
    assert _bitwise(plain, out)
    for p, g in enumerate(grads):
        want = (cots[p + d] if p % size + d < size
                else torch.zeros_like(cots[p]))
        assert torch.equal(g, want)
    assert [(b, i, g) for _, _, b, i, g in puts[-1:]] == [("xla", True,
                                                            True)]


LAYOUTS = {"flat": GroupLayout(AXES2, 4, 1, ulysses_outer=True),
           "hier": GroupLayout(AXES2, 4, 1, ulysses_outer=True, u_groups=2)}


def _a2a(name, backend):
    """(all-to-all, its inverse) of one program, split and concatenated
    on axis 1."""
    layout = LAYOUTS["hier" if name == "hier" else "flat"]
    kw = dict(backend=backend, interpret=True)
    if name == "staged":
        return (lambda x: staged_all_to_all(x, layout, split_axis=1, **kw),
                lambda s: staged_ungroup(s, layout, concat_axis=1, **kw))
    if name == "hier":
        return (lambda x: hier_all_to_all(x, layout, split_axis=1, **kw),
                lambda s: hier_ungroup(s, layout, concat_axis=1, **kw))
    return (lambda x: monolithic_all_to_all(x, layout, split_axis=1, **kw),
            lambda s: ungroup_all_to_all(s, layout, concat_axis=1, **kw))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["staged", "hier", "monolithic"])
def test_all_to_all_gradient_is_its_inverse(name, backend, puts):
    """An all-to-all only routes, so its transpose is its inverse: the
    gradient of the all-to-all is the ungroup of the cotangents, and the
    gradient of the ungroup is the all-to-all of its cotangents; every
    backward put runs the inverse route of a forward put."""
    fwd, inv = _a2a(name, backend)
    xs = [_ranks(4, (2, 8, 3), 6)]
    with torch.no_grad():
        stacked = fwd(xs[0])
    cots = _ranks(4, tuple(stacked[0].shape), 7)
    plain, out, grads = _vjp(fwd, xs, cots)
    assert _bitwise(plain, out)
    with torch.no_grad():
        assert _bitwise(list(grads), inv(cots))
    plain, out, grads = _vjp(inv, [stacked], xs[0])
    assert _bitwise(plain, out)
    with torch.no_grad():
        assert _bitwise(list(grads), fwd(xs[0]))
    forward = {(a, p, b, i) for a, p, b, i, g in puts if not g}
    backward = [(a, put_grad.inverse_perm(p), b, i)
                for a, p, b, i, g in puts if g]
    if name == "monolithic" and backend == "xla":
        assert not forward  # one atomic exchange: torch.stack
    else:
        assert forward and {b for _, _, b, _ in forward} == {backend}
    assert forward <= set(backward)


def test_no_grad_wraps_nothing(monkeypatch):
    monkeypatch.setattr(put_grad.Put, "apply",
                        lambda *a: pytest.fail("the put was wrapped"))
    ch = Channel(axes=AXES2, perm=((0, 1), (1, 0)), backend="pallas")
    xs = [t.requires_grad_() for t in _ranks(2, (3,), 8)]
    with torch.no_grad():
        out = ch.put(xs).wait()
    assert all(t.grad_fn is None for t in out)
    out = ch.put([x.detach() for x in xs]).wait()  # no input wants one
    assert all(not t.requires_grad for t in out)


def test_fp8_wire_refuses_a_gradient():
    layout = LAYOUTS["hier"]
    xs = [t.requires_grad_() for t in _ranks(4, (2, 8, 3), 9)]
    with pytest.raises(NotImplementedError, match="fp8"):
        hier_all_to_all(xs, layout, split_axis=1,
                        wire_dtype="float8_e4m3fn")


def test_detached_puts_break_rwkv6_gradient_parity(monkeypatch):
    """Reduced rwkv6 over (pod 2, model 2): within its bound of degree 1
    with the put's gradient; with every put's outputs detached (the token
    shifts' and the state passes' received buffers without a gradient
    function) the ranks' gradients lose what crosses a rank and the gap
    is far over the bound."""
    arch = "rwkv6-1.6b"
    cfg, _ = _cfgs(arch)
    tree, batch = _case_inputs(arch)
    _, want = port_loss_and_grads(cfg, tree, batch)
    _, got = port_loss_and_grads(cfg, tree, batch, "pod2-model2")
    assert grad_gap(cfg, got, want) < SELF_BOUND[arch]

    def detached(channel, issue, tensors):
        with torch.no_grad():
            return issue(tuple(tensors))

    monkeypatch.setattr(put_grad, "put_with_grad", detached)
    _, broken = port_loss_and_grads(cfg, tree, batch, "pod2-model2")
    assert grad_gap(cfg, broken, want) > 1e-2
