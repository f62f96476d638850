"""The slice as a whole: the core stack trained through the tape, held
against the JAX package's on the same weights and batches.

* The ``bert_like`` transformer of the reference's overhead benchmark
  (``_tape_transformer``: b 4, s 64, d 64, 4 heads, 2 layers, vocab 256),
  under the port's ``hopper`` backend on the CPU (the matmul kernel's
  plain version) against the reference under ``jnp`` and under
  ``pallas`` in interpret mode; at d 128 as well, where the reference's
  Pallas matmul takes its kernel path.  Weights come across through
  ``convert.module_params``.  Held: the loss to 1e-5 relative, every
  gradient leaf by its relative L2 error to 1e-4, and every parameter
  after 3 steps of SGD with momentum (``step`` / ``zeroGrad``) by its
  relative L2 error to 1e-4.  A leaf whose gradient is below a thousandth
  of the global gradient norm (the key biases, whose exact gradient is
  zero: a softmax does not see a bias added to every score of a row) is
  held against that floor instead of its own norm, since both packages
  return rounding noise there.
* The quickstart CNN (``examples/quickstart.py``) on the same weights and
  a reduced dataset: per-step losses to 1e-5 and parameters after the
  steps to 1e-4, dropout off (the two packages draw different masks),
  and the port's own quickstart loop at reduced n.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import autograd as jag
from repro.core import nn as jnn
from repro.core import optim as joptim
from repro.core.autograd import functions as JF
from repro_torch import convert
from repro_torch.core import nn as tnn
from repro_torch.core.autograd import noGrad
from repro_torch.core.optim import SGD
from repro_torch.core.tensor import HopperBackend
from repro_torch.launch import quickstart
from repro_torch.launch.tape_transformer import TapeTransformer

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-4
FLOOR = 1e-3         # of the global gradient norm
SGD_KW = dict(lr=0.05, momentum=0.9)

BERT_LIKE = dict(b=4, s=64, d=64, heads=4, layers=2, vocab=256)


def _ref_transformer(key, d, heads, layers, vocab):
    """The reference benchmark's ``_tape_transformer`` modules."""
    blocks = [jnn.TransformerBlock(d, heads, key=jax.random.fold_in(key, i))
              for i in range(layers)]
    emb = jnn.Embedding(vocab, d, key=jax.random.fold_in(key, 99))
    head = jnn.Linear(d, vocab, key=jax.random.fold_in(key, 100))
    return emb, blocks, head, jnn.Container(emb, *blocks, head)


def _ref_loss(emb, blocks, head, toks, labels, vocab):
    b, s = toks.shape
    h = emb(jnp.asarray(toks))
    for blk in blocks:
        h = blk(h)
    logits = head(h)
    return jnn.categoricalCrossEntropy(
        JF.reshape(logits, (b * s, vocab)),
        jag.Variable(jnp.asarray(labels.reshape(-1))))


def _rel(got, want, floor=0.0):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), floor, 1e-30))


def _grads_np(named):
    return {k: np.asarray(v.grad) if not isinstance(v.grad, torch.Tensor)
            else v.grad.numpy() for k, v in named}


def _batches(shape, n):
    rng = np.random.default_rng(7)
    b, s, vocab = shape["b"], shape["s"], shape["vocab"]
    return [(rng.integers(0, vocab, (b, s)).astype(np.int32),
             rng.integers(0, vocab, (b, s)).astype(np.int32))
            for _ in range(n)]


def _run_both(shape, ref_backend, steps):
    """Reference (under ``ref_backend``) and port (``hopper`` on the CPU)
    from the same weights: first-step loss and gradients, then the
    parameters after ``steps`` SGD steps."""
    d, heads, layers, vocab = (shape[k] for k in ("d", "heads", "layers",
                                                  "vocab"))
    batches = _batches(shape, steps)
    with repro.session(backend=ref_backend) as sess:
        emb, blocks, head, cont = _ref_transformer(
            jax.random.PRNGKey(0), d, heads, layers, vocab)
        init = {k: np.asarray(v) for k, v in cont.param_pytree().items()}
        opt = joptim.SGD(cont.params(), **SGD_KW)
        ref_losses = []
        for i, (toks, labels) in enumerate(batches):
            loss = _ref_loss(emb, blocks, head, toks, labels, vocab)
            ref_losses.append(float(loss.data))
            loss.backward()
            if i == 0:
                ref_grads = _grads_np(cont.named_params())
            opt.step()
            opt.zeroGrad()
        ref_params = {k: np.asarray(v) for k, v in cont.param_pytree().items()}
        ref_kernel_calls = getattr(sess.backend_instance(), "kernel_calls",
                                   None)

    with repro_torch.session(backend=HopperBackend()) as sess:
        model = TapeTransformer(d, heads, layers, vocab, device="cpu")
        convert.module_params(model.container, init)
        opt = SGD(model.container.params(), **SGD_KW)
        losses = []
        for i, (toks, labels) in enumerate(batches):
            loss = model.loss(torch.from_numpy(toks).long(),
                              torch.from_numpy(labels).long())
            losses.append(float(loss.data))
            loss.backward()
            if i == 0:
                grads = _grads_np(model.container.named_params())
            opt.step()
            opt.zeroGrad()
        params = {k: v.data.numpy()
                  for k, v in model.container.named_params()}
        calls = sess.backend_instance().kernel_calls
    return dict(ref_losses=ref_losses, ref_grads=ref_grads,
                ref_params=ref_params, losses=losses, grads=grads,
                params=params, model=model, ref_kernel_calls=ref_kernel_calls,
                kernel_calls=calls)


CASES = {"jnp": ("jnp", BERT_LIKE), "pallas": ("pallas", BERT_LIKE),
         "pallas_d128": ("pallas", dict(BERT_LIKE, d=128))}


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, case):
    if case not in runs:
        backend, shape = CASES[case]
        runs[case] = _run_both(shape, backend, steps=3)
    return runs[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_like_loss_and_gradients(case, runs):
    r = _get(runs, case)
    assert r["losses"][0] == pytest.approx(r["ref_losses"][0], rel=LOSS_RTOL)
    gnorm = np.sqrt(sum(np.sum(g ** 2) for g in r["ref_grads"].values()))
    assert set(r["grads"]) == set(r["ref_grads"])
    for name, want in r["ref_grads"].items():
        err = _rel(r["grads"][name], want, FLOOR * gnorm)
        assert err <= GRAD_RTOL, (name, err)
    if case == "pallas_d128":
        assert r["ref_kernel_calls"] > 0   # the reference ran its kernel


@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_like_three_sgd_momentum_steps(case, runs):
    r = _get(runs, case)
    np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=LOSS_RTOL)
    for name, want in r["ref_params"].items():
        err = _rel(r["params"][name], want, FLOOR)
        assert err <= PARAM_RTOL, (name, err)
    per_step = r["model"].matmuls_per_step()
    assert per_step == 3 * (8 * CASES[case][1]["layers"] + 1)
    assert r["kernel_calls"] == 3 * per_step


# -- the quickstart CNN ------------------------------------------------------

def _ref_cnn():
    return jnn.Sequential(
        jnn.Conv2D(1, 8, 3, 3), jnn.ReLU(), jnn.Pool2D(2, 2, 2, 2),
        jnn.Conv2D(8, 16, 3, 3), jnn.ReLU(), jnn.Pool2D(2, 2, 2, 2),
        jnn.View((-1, 3 * 3 * 16)),
        jnn.Linear(3 * 3 * 16, 64), jnn.ReLU(), jnn.Dropout(0.1),
        jnn.Linear(64, 10), jnn.LogSoftmax())


def test_quickstart_cnn_matches_reference_steps():
    xs, ys = quickstart.load_dataset(n=4 * 64)
    ref = _ref_cnn().eval()
    model = quickstart.build_model(device="cpu").eval()
    convert.module_params(model, {k: np.asarray(v)
                                  for k, v in ref.param_pytree().items()})
    ropt = joptim.SGDOptimizer(ref.params(), lr=0.1, momentum=0.9)
    with repro_torch.session(backend=HopperBackend()) as sess:
        topt = SGD(model.params(), lr=0.1, momentum=0.9)
        for i in range(4):
            bx, by = xs[64 * i: 64 * (i + 1)], ys[64 * i: 64 * (i + 1)]
            rl = jnn.categoricalCrossEntropy(ref(jag.noGrad(jnp.asarray(bx))),
                                             jag.noGrad(jnp.asarray(by)))
            tl = tnn.categoricalCrossEntropy(
                model(noGrad(torch.from_numpy(bx))),
                noGrad(torch.from_numpy(by).long()))
            assert float(tl.data) == pytest.approx(float(rl.data),
                                                   rel=LOSS_RTOL)
            rl.backward()
            tl.backward()
            ropt.step()
            ropt.zeroGrad()
            topt.step()
            topt.zeroGrad()
        assert sess.backend_instance().kernel_calls == 4 * 3 * 2
    for name, p in model.named_params():
        want = np.asarray(dict(ref.named_params())[name].data)
        assert _rel(p.data.numpy(), want) <= PARAM_RTOL, name


def test_quickstart_loop_runs_at_reduced_n():
    logs = []
    val_loss, val_err = quickstart.run(backend="hopper", device="cpu",
                                       epochs=2, n=256 + 4 * 64,
                                       log=logs.append)
    assert len(logs) == 2 and np.isfinite(val_loss)
    assert 0.0 <= val_err <= 100.0


def test_core_entry_points_default_to_the_card():
    import inspect

    for fn in (tnn.Linear.__init__, tnn.Embedding.__init__,
               tnn.LayerNorm.__init__, tnn.RMSNorm.__init__,
               tnn.Conv2D.__init__, tnn.MultiHeadAttention.__init__,
               tnn.TransformerBlock.__init__, TapeTransformer.__init__,
               quickstart.build_model, quickstart.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
