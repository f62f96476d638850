"""The port's training path on the CPU against the JAX package.

The reduced codeqwen1.5-7b config runs in float32 in both packages from
the reference's ``LM.init`` weights (through ``repro_torch.convert``);
batches are made with numpy from fixed seeds.  Tolerances, with their
reasons:

* loss to 1e-5 relative and every gradient leaf to 2e-5 absolute plus
  2e-4 relative: the frameworks sum in other orders (matmuls, softmax,
  the chunked CE's mean of means), and the reduced model's gradients are
  of order 1e-3 to 1e-1;
* the optimizers on identical gradient trees to 1e-6 relative (fp32):
  the same element-wise formulas, with the bias corrections and the
  learning rate taken in float64 on the host here and float32 in the
  reference; bfloat16 parameters to one bf16 ulp;
* a whole 3-step ``train()`` run: losses to 1e-4 relative (Adam's first
  update is ~lr * sign(g), so gradient noise near 0 moves parameters by
  up to 2 lr; the loss over three steps stays within that).
"""

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import optim as joptim
from repro.launch.train import make_batches as jax_make_batches
from repro.models import build_model
from repro.training.checkpoint import CheckpointManager as JaxCheckpoints
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro.training.train_loop import train as jax_train
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import optim
from repro_torch.launch import train as launch
from repro_torch.models import LM
from repro_torch.models.meta import tree_leaves, tree_map
from repro_torch.training import CheckpointManager, TrainConfig, train

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _batch(seed: int, b: int = 2, s: int = 32, vocab: int = 512) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32),
            "labels": rng.integers(0, vocab, (b, s), dtype=np.int32)}


@pytest.fixture(scope="module")
def jax_params():
    """The reference's initial weights as numpy (each JAX call makes its
    own arrays from them: ``train`` donates its inputs)."""
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(jp, **cfg_kw):
    model = LM(get_config("codeqwen1.5-7b", reduced=True, **cfg_kw),
               device="cpu")
    params = convert.params_from_jax(jp, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return model, params


def _by_path(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


def _jax_value_and_grad(jp, ce_impl, batch):
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True,
                                ce_impl=ce_impl))
    (loss, metrics), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        _jnp(jp), _jnp(batch))
    return float(loss), metrics, grads


@pytest.mark.parametrize("ce_impl", ["dense", "chunked"])
def test_loss_and_every_gradient_leaf_match_jax(jax_params, ce_impl):
    batch = _batch(0)
    want_loss, want_metrics, want_grads = _jax_value_and_grad(
        jax_params, ce_impl, batch)
    for impl in ("ref", "pallas", "blockwise"):
        model, params = _port(jax_params, ce_impl=ce_impl,
                              attention_impl=impl)
        loss, metrics = model.loss_fn(params, batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), want_loss,
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(metrics["ce"].detach()),
                                   float(want_metrics["ce"]), **LOSS_TOL)
        assert float(metrics["moe_aux"]) == 0.0
        flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
        assert len(flat) == len(tree_leaves(params))
        for path, g in flat:
            got = _by_path(params, path).grad
            np.testing.assert_allclose(
                got.numpy(), np.asarray(g), **GRAD_TOL,
                err_msg=f"{impl} {jax.tree_util.keystr(path)}")


def test_remat_none_and_full_give_identical_gradients(jax_params):
    batch = _batch(1)
    grads = {}
    for remat in ("none", "full"):
        model, params = _port(jax_params, remat=remat,
                              attention_impl="pallas")
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
        grads[remat] = [p.grad for p in tree_leaves(params)]
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)
    model, params = _port(jax_params, remat="dots")
    with pytest.raises(NotImplementedError, match="dots"):
        model.loss_fn(params, batch)


def _opt_trees(seed: int):
    """A parameter tree with fp32 and bf16 leaves, and three gradient
    trees, as numpy (bf16 values exactly representable)."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return a.astype(ml_dtypes.bfloat16)

    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32),
                    bf16(rng.standard_normal((5, 2)))]}
    grads = [{"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32),
                    bf16(rng.standard_normal((5, 2)))]} for _ in range(3)]
    return params, grads


def _to_torch(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


def _assert_tree_close(got, want, rtol=1e-6, atol=1e-7):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       rtol=2.0 ** -8, atol=1e-7)
        else:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,kw", [("Adam", {}),
                                     ("Adam", {"weight_decay": 0.01}),
                                     ("AdamW", {}),
                                     ("AdamW", {"b2": 0.999,
                                                "weight_decay": 0.3})])
def test_optimizers_match_jax_on_identical_gradients(name, kw):
    params, grads = _opt_trees(7)
    jopt = getattr(joptim, name)(lr=1e-2, **kw)
    topt = getattr(optim, name)(lr=1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    _assert_tree_close(ts, js)
    for count, g in enumerate(grads, start=1):
        lr = 1e-2 * count
        jp, js = jopt.apply_with_count(jp, jax.tree.map(jnp.asarray, g), js,
                                       jnp.float32(lr), count)
        tp, ts = topt.apply_with_count(tp, _to_torch(g), ts, lr, count)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts, js)
    # the functional apply counts its own steps
    jopt2, topt2 = getattr(joptim, name)(lr=1e-3, **kw), \
        getattr(optim, name)(lr=1e-3, **kw)
    jp2, js2 = jopt2.apply(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, grads[0]),
                           jopt2.init(jax.tree.map(jnp.asarray, params)),
                           None)
    tp2, ts2 = topt2.apply(_to_torch(params), _to_torch(grads[0]),
                           topt2.init(_to_torch(params)), None)
    _assert_tree_close(tp2, jp2)
    assert topt2.step_count == jopt2.step_count == 1


def test_opt_state_crosses_from_jax_and_updates_alike(jax_params):
    """One AdamW step in JAX; its state converted with
    ``opt_state_from_jax`` equals the port's after the same step from the
    same weights and gradients, and a second step from the converted state
    keeps both packages together (``to_numpy`` reads the port's side)."""
    _, _, jgrads = _jax_value_and_grad(jax_params, "dense", _batch(3))
    jg = jax.tree.map(np.asarray, jgrads)
    jopt, topt = joptim.AdamW(lr=1e-3), optim.AdamW(lr=1e-3)
    jp, js = jopt.apply_with_count(_jnp(jax_params), _jnp(jg),
                                   jopt.init(_jnp(jax_params)), 1e-3, 1)
    tp = convert.params_from_jax(jax_params, "cpu")
    tp, ts = topt.apply_with_count(tp, convert.params_from_jax(jg, "cpu"),
                                   topt.init(tp), 1e-3, 1)
    crossed = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    _assert_tree_close(ts, js)
    for a, b in zip(tree_leaves(crossed), tree_leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jp, js = jopt.apply_with_count(jp, _jnp(jg), js, 5e-4, 2)
    tp, _ = topt.apply_with_count(tp, convert.params_from_jax(jg, "cpu"),
                                  crossed, 5e-4, 2)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = _opt_trees(8)
    want, want_norm = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads[0]), max_norm)
    got, norm = optim.clip_by_global_norm(_to_torch(grads[0]), max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    _assert_tree_close(got, want)


def test_schedules_match_jax():
    for make in ("cosine_schedule", "linear_schedule"):
        want = getattr(joptim, make)(3e-4, 4, 20)
        got = getattr(optim, make)(3e-4, 4, 20)
        for step in range(0, 24):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_matches_jax_train_on_the_same_batches(jax_params, accum):
    batches = [_batch(10 + i, b=4, s=16) for i in range(3)]
    tkw = dict(steps=3, base_lr=1e-3, warmup=1, accum=accum, log_every=100)
    jm = build_model(jax_config("codeqwen1.5-7b", reduced=True))
    _, jhist = jax_train(jm, _jnp(jax_params), iter([_jnp(b) for b in batches]),
                         JaxTrainConfig(**tkw), log_fn=lambda _: None)
    model, params = _port(jax_params)
    params, thist = train(model, params, iter(batches), TrainConfig(**tkw),
                          log_fn=lambda _: None)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)


def test_make_batches_yields_the_reference_arrays():
    jcfg = jax_config("codeqwen1.5-7b", reduced=True)
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    want = list(jax_make_batches(jcfg, 2, 64, 3, seed=1))
    before = threading.active_count()
    got = list(launch.make_batches(cfg, 2, 64, 3, seed=1))
    assert threading.active_count() == before   # prefetch threads ended
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def _tree_for_checkpoint():
    """(params, opt_state)-shaped tree with bf16, fp32 and int32 leaves,
    as numpy for JAX and as tensors for the port."""
    rng = np.random.default_rng(9)
    params = {"embed": rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16),
              "stages": [{"attn": {"wq": rng.standard_normal(
                  (2, 4, 4)).astype(ml_dtypes.bfloat16)}}],
              "final_norm": {"scale": np.ones(4, np.float32)}}
    opt = jax.tree.map(lambda a: {"m": rng.standard_normal(a.shape)
                                  .astype(np.float32),
                                  "v": np.abs(rng.standard_normal(a.shape))
                                  .astype(np.float32)}, params)
    opt["count"] = np.array(3, np.int32)
    return params, opt


def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path):
    tree = _tree_for_checkpoint()
    port_tree = _to_torch(tree)
    CheckpointManager(tmp_path / "port").save(5, port_tree, {"step": 5})
    JaxCheckpoints(tmp_path / "jax").save(5, jax.tree.map(jnp.asarray, tree),
                                          {"step": 5})
    # the two writers produce the same bytes, file for file
    pdir, jdir = tmp_path / "port/step_0000000005", \
        tmp_path / "jax/step_0000000005"
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    for f in jdir.iterdir():
        assert (pdir / f.name).read_bytes() == f.read_bytes(), f.name
    # the reference restores the port's checkpoint bit for bit ...
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), tree)
    got, extra = JaxCheckpoints(tmp_path / "port").restore(like)
    assert extra == {"step": 5}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == w.dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    # ... and the port restores the reference's
    tlike = tree_map(torch.zeros_like, port_tree)
    got, extra = CheckpointManager(tmp_path / "jax").restore(tlike)
    assert extra == {"step": 5}
    for g, w in zip(tree_leaves(got), tree_leaves(port_tree)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_checkpoint_manager_keeps_the_newest_and_saves_async(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    t = {"w": torch.arange(6, dtype=torch.bfloat16)}
    for step in (1, 2, 3):
        ckpt.save_async(step, t, {"step": step})
        t["w"].add_(1)          # the snapshot was taken before the update
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3]
    assert not list(tmp_path.glob("*.tmp"))
    got, extra = ckpt.restore({"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert extra == {"step": 3}
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.bfloat16) + 2)
    with pytest.raises(NotImplementedError, match="shardings"):
        ckpt.restore({"w": torch.zeros(6)}, shardings={"w": None})


def test_train_resumes_from_its_checkpoint(jax_params, tmp_path):
    batches = [_batch(20 + i, b=2, s=16) for i in range(4)]
    kw = dict(base_lr=1e-3, warmup=1, log_every=100,
              checkpoint_dir=str(tmp_path))
    model, params = _port(jax_params)
    _, first = train(model, params, iter(batches[:2]),
                     TrainConfig(steps=2, **kw), log_fn=lambda _: None)
    assert CheckpointManager(tmp_path).latest_step() == 2
    model, params = _port(jax_params)
    logs = []
    _, rest = train(model, params, iter(batches[2:]),
                    TrainConfig(steps=4, **kw), log_fn=logs.append)
    assert any("resumed from step 2" in line for line in logs)
    assert [h["step"] for h in first + rest] == [0, 1, 2, 3]


def test_launcher_trains_on_the_cpu_and_refuses_without_a_card(capsys):
    history = launch.main(["--reduced", "--device", "cpu", "--steps", "5",
                           "--batch", "4", "--seq", "64"])
    assert len(history) == 5
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert "[train] loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(["--reduced", "--steps", "1"])


def test_loss_fn_refuses_what_is_not_ported(jax_params):
    model, params = _port(jax_params)
    with pytest.raises(NotImplementedError, match="image"):
        model.loss_fn(params, dict(_batch(0), image_embeds=np.zeros(1)))
    with pytest.raises(NotImplementedError, match="mtp"):
        LM(get_config("codeqwen1.5-7b", reduced=True, mtp_depth=1),
           device="cpu")
