"""The port's tape autograd against the reference tape on the same graphs
(the cases of tests/test_autograd.py): values and gradients through
``value_and_grad``, the §5.2.1 hooks (pruning, pre-fused nodes, node
lifetime), ``no_grad`` / ``detach`` and accumulation, under the default
backend and under ``HopperBackend`` (its matmul's plain version on the
CPU).

Inputs come from a seeded numpy generator and cross as numpy.  Values and
gradients are held to 1e-5 relative (absolute 1e-6): both tapes compose
the same float32 VJPs, and only summation orders differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autograd as jag
from repro.core.autograd import functions as JF
from repro.core.tensor import ops as jops
from repro_torch.core import autograd as tag
from repro_torch.core.autograd import functions as TF
from repro_torch.core.tensor import ops as tops

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _both(loss_of, params: dict, backend: str = "torch"):
    """Value and gradients of ``loss_of(F, V, p)`` on the reference tape
    and on the port's tape (under ``backend``), from numpy params."""
    jval, jgrads = jag.value_and_grad(lambda p: loss_of(JF, jag.Variable, p))(
        {k: jnp.asarray(v) for k, v in params.items()})
    with repro_torch.session(backend=backend):
        tval, tgrads = tag.value_and_grad(
            lambda p: loss_of(TF, tag.Variable, p))(
            {k: torch.from_numpy(v.copy()) for k, v in params.items()})
    return (tval, tgrads), (jval, jgrads)


# chains of the unary ops the reference test draws from (exp, tanh, relu,
# sigmoid, neg, gelu, silu)
CHAINS = [["exp"], ["tanh", "relu"], ["sigmoid", "gelu", "neg"],
          ["silu", "tanh", "exp"], ["relu", "sigmoid", "silu", "gelu", "tanh"]]


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("chain", CHAINS, ids=lambda c: "-".join(c))
def test_tape_matches_reference_on_unary_chains(chain, backend):
    """Unary-op chains over a matmul: value and gradient of the weight."""
    rng = np.random.default_rng(len(chain))
    x = (0.5 * rng.standard_normal((5, 4))).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 5))).astype(np.float32)

    def loss(F, V, p):
        h = F.matmul(V(jnp.asarray(x) if F is JF else torch.from_numpy(x)),
                     p["w"])
        for name in chain:
            h = getattr(F, name)(h)
        return F.mean(F.mul(h, h))

    (tval, tg), (jval, jg) = _both(loss, {"w": w}, backend)
    _close(tval, jval)
    _close(tg, jg)


@pytest.mark.parametrize("reduction", ["sum", "mean", "max"])
def test_reductions_and_shape_ops(reduction):
    x = np.random.default_rng(0).standard_normal((3, 4, 5)).astype(
        np.float32)

    def loss(F, V, p):
        h = F.transpose(F.reshape(p["x"], (3, 20)), (1, 0))
        r = getattr(F, reduction)(h, axis=0)
        return F.sum(F.mul(r, r))

    (tval, tg), (jval, jg) = _both(loss, {"x": x})
    _close(tval, jval)
    _close(tg, jg)


@pytest.mark.parametrize("op", ["add", "mul", "sub", "div", "maximum"])
def test_broadcasting_binary_grads(op):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 1, 3)).astype(np.float32)
    b = rng.standard_normal((5, 3)).astype(np.float32)
    (tval, tg), (jval, jg) = _both(
        lambda F, V, p: F.sum(getattr(F, op)(p["a"], p["b"])),
        {"a": a, "b": b})
    _close(tval, jval)
    _close(tg, jg)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_matmul_batched_and_broadcast_grads(backend):
    """The explicit matmul VJP: a Linear-style [B, S, K] @ [K, N] (weight
    gradient folded into one product), a batched [B, H, S, D] @ [B, H, D,
    S] and a broadcast [B, 1, M, K] @ [H, K, N]."""
    rng = np.random.default_rng(2)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    params = {"x": f32(2, 3, 4), "w": f32(4, 5), "q": f32(2, 3, 4, 6),
              "k": f32(2, 3, 6, 4), "a": f32(2, 1, 3, 4), "b": f32(3, 4, 2)}

    def loss(F, V, p):
        terms = [F.matmul(p["x"], p["w"]), F.matmul(p["q"], p["k"]),
                 F.matmul(p["a"], p["b"])]
        return F.add(F.add(F.sum(F.tanh(terms[0])), F.sum(F.tanh(terms[1]))),
                     F.sum(F.tanh(terms[2])))

    (tval, tg), (jval, jg) = _both(loss, params, backend)
    _close(tval, jval)
    _close(tg, jg)


@pytest.mark.parametrize("op", ["layer_norm", "rms_norm", "softmax",
                                "log_softmax", "take", "where", "getitem",
                                "concatenate", "astype", "sqrt", "log",
                                "broadcast_to", "conv2d", "dot_general"])
def test_composite_and_lifted_op_grads(op):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    idx = np.array([[0, 3], [2, 2], [1, 0]], np.int32)
    img = rng.standard_normal((2, 5, 5, 2)).astype(np.float32)
    ker = (0.3 * rng.standard_normal((3, 3, 2, 3))).astype(np.float32)

    def loss(F, V, p):
        tensor = jnp.asarray if F is JF else (
            lambda a: torch.from_numpy(a.copy()))
        if op == "layer_norm":
            h = F.layer_norm(p["x"], p["w"], p["b"])
        elif op == "rms_norm":
            h = F.rms_norm(p["x"], p["w"])
        elif op in ("softmax", "log_softmax"):
            h = getattr(F, op)(p["x"], axis=-1)
        elif op == "take":
            h = F.take(p["x"], tensor(idx), axis=0)
        elif op == "where":
            h = F.where(tensor(x > 0), p["x"], F.mul(p["x"], p["x"]))
        elif op == "getitem":
            h = p["x"][1:3, ::2]
        elif op == "concatenate":
            h = F.concatenate([p["x"], F.tanh(p["x"])], axis=1)
        elif op == "astype":
            h = F.astype(F.mul(p["x"], p["x"]),
                         jnp.float32 if F is JF else torch.float32)
        elif op in ("sqrt", "log"):
            h = getattr(F, op)(F.add(F.mul(p["x"], p["x"]),
                                     V(tensor(np.array(0.5, np.float32)))))
        elif op == "broadcast_to":
            h = F.broadcast_to(p["w"], (3, 6))
        elif op == "conv2d":
            h = F.conv2d(p["img"], p["ker"], stride=(1, 1), padding="SAME")
        else:
            h = F.dot_general(p["x"], p["x"], (((1,), (1,)), ((), ())))
        return F.sum(F.mul(h, F.tanh(h)))

    (tval, tg), (jval, jg) = _both(
        loss, {"x": x, "w": w, "b": bias, "img": img, "ker": ker})
    _close(tval, jval)
    _close(tg, jg)


def test_softmax_logsoftmax_ce_grads():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = (np.arange(6) % 10).astype(np.int32)
    (tval, tg), (jval, jg) = _both(
        lambda F, V, p: F.cross_entropy(
            p["l"], jnp.asarray(labels) if F is JF
            else torch.from_numpy(labels)), {"l": logits})
    _close(tval, jval)
    _close(tg, jg)


def test_graph_pruning_cuts_subtrees():
    """§5.2.1 on-the-fly pruning: cut gradient flow into a named subtree."""
    x = tag.Variable(torch.ones(4), requires_grad=True)
    y = tag.Variable(torch.ones(4), requires_grad=True)
    out = TF.sum(TF.add(TF.exp(x), TF.mul(y, y)))
    out.backward(prune=lambda node: node.name == "exp")
    assert x.grad is None
    np.testing.assert_allclose(_np(y.grad), 2 * np.ones(4))


def test_fused_composite_is_one_node():
    """§5.2.1 pre-fused gradients: a composite records one tape node and
    gives the unfused tape's gradient (and the reference's)."""
    def composite_t(v):
        return tops.mul(tops.tanh(v), tops.exp(v))

    x = tag.Variable(torch.full((8,), 0.3), requires_grad=True)
    fused = tag.fused(composite_t, name="tanh_exp")(x)
    assert tag.tape_size(fused) == 1
    unfused = TF.mul(TF.tanh(x), TF.exp(x))
    assert tag.tape_size(unfused) == 3
    TF.sum(fused).backward()
    gf = _np(x.grad)
    x.zero_grad()
    TF.sum(unfused).backward()
    np.testing.assert_allclose(gf, _np(x.grad), rtol=RTOL)

    jx = jag.Variable(jnp.full((8,), 0.3), requires_grad=True)
    JF.sum(jag.fused(lambda v: jops.mul(jops.tanh(v), jops.exp(v)))(
        jx)).backward()
    np.testing.assert_allclose(gf, np.asarray(jx.grad), rtol=RTOL)


def test_free_on_use_node_lifetime():
    """§5.2.1 custom node lifetime: consumed nodes refuse reuse."""
    x = tag.Variable(torch.ones(4), requires_grad=True)
    y = TF.sum(TF.exp(x))
    y.backward(free_on_use=True)
    with pytest.raises(RuntimeError, match="consumed"):
        y.backward()
    x2 = tag.Variable(torch.ones(4), requires_grad=True)
    y2 = TF.sum(TF.exp(x2))
    y2.backward(free_on_use=False)
    y2.backward(free_on_use=False)
    np.testing.assert_allclose(_np(x2.grad), 2 * np.e * np.ones(4),
                               rtol=1e-6)


def test_no_grad_and_detach():
    x = tag.Variable(torch.ones(4), requires_grad=True)
    with tag.no_grad():
        y = TF.mul(x, x)
    assert y.node is None
    assert tag.grad_enabled()
    z = TF.mul(x.detach(), x.detach())
    assert z.node is None
    c = tag.noGrad(torch.ones(4))
    assert not c.requires_grad and c.node is None


def test_grad_accumulation_across_backwards():
    x = tag.Variable(torch.ones(3), requires_grad=True)
    TF.sum(TF.mul(x, x)).backward()
    g1 = _np(x.grad)
    TF.sum(TF.mul(x, x)).backward()   # accumulates
    np.testing.assert_allclose(_np(x.grad), 2 * g1)
    # accumulate=False overwrites at every contribution, as in the
    # reference: x * x reaches x twice, and the last one stands
    TF.sum(TF.mul(x, x)).backward(accumulate=False)
    jx = jag.Variable(jnp.ones(3), requires_grad=True)
    JF.sum(JF.mul(jx, jx)).backward(accumulate=False)
    np.testing.assert_allclose(_np(x.grad), np.asarray(jx.grad))


def test_tape_never_touches_torch_autograd():
    """The tape is the framework's own: no tensor it makes requires
    torch's grad, and it works under torch.no_grad()."""
    w = tag.Variable(torch.randn(3, 2, generator=torch.Generator()
                                 .manual_seed(0)), requires_grad=True)
    with torch.no_grad():
        loss = TF.sum(TF.tanh(TF.matmul(tag.Variable(torch.ones(4, 3)), w)))
        loss.backward()
    assert not loss.data.requires_grad and w.grad is not None
    assert not w.grad.requires_grad
