"""MobileNet-v2's dp × tp training step of the port (nnstreamer_tpu_torch/
parallel/train.py, the train-mode batch norm of models/nn.py) against the
JAX package's ``make_train_step`` on the same weights and batch: 32×32
uint8 images, 16 classes, batch 4; the port on the (2, 4) mesh of 8 CPU
positions, the reference on its 8 virtual devices as (1, 8). The
reference has no single-process test of train.py.

Why (1, 8) for the reference. On XLA:CPU the JAX package's step on a mesh
with both dp > 1 and tp > 1 multiplies every depthwise conv's weight
gradient by tp (×4 on (2, 4), ×2 on (2, 2) and (4, 2)); its steps on
(1, n), (n, 1), one device and its eager gradient agree on it, and so
does its float64 step. ``test_reference_dp_tp_mesh_scales_depthwise_
gradients`` pins that; the port does not reproduce it.

Tolerances. In float32 this gradient is ill-conditioned at any size
tried (32² × 4, 96² × 8, 128² × 8, 224² × 4): 50 batch norms amplify
rounding, and the JAX package's own float32 step lies up to 6 % (momentum
tree, relative norm) from its float64 step from the same state. So:

- ``float64``: the port's step and the reference's, both in float64, each
  step from the reference's state before it; every leaf of the updated
  parameters and momentum within 5e-7 of that leaf's largest magnitude
  (readings 5.6e-8 and 7.3e-8 over the two steps, 3.2e-7 at a third: both
  cast the logits to float32, and an ulp that rounds the other way moves
  the gradient that much), plus 1e-14 of the tree's largest for the
  leaves whose gradient is zero (a batch norm's bias that feeds a linear
  conv and another batch norm; reading 9.9e-16). The loss within 1e-7
  relative (reading 0). dp = 2 against dp = 1 is held here too.
- ``float32``: each quantity of a step (the loss, the momentum tree's and
  the update's relative norm, against the reference's float64 step from
  the same state) within twice the largest error of the reference's own
  float32 step over the steps (readings: the reference's momentum 6.3e-2
  and 2.2e-4, the port's 1.3e-2 and 1.0e-4).

What is well conditioned anyway is held tightly: the single-device
train-mode forward at 64×64, 1e-4; the optimizer's rule
(``torch.optim.SGD(momentum=0.9)`` against ``optax.sgd``), 1e-6; mean and
var, unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.parallel import train as jtrain
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu_torch.models import jax_weights, mobilenet_v2
from nnstreamer_tpu_torch.parallel import train
from nnstreamer_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

LR = 0.05
STEPS = 2
REF_MESH = (1, 8)


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


def make_mesh(n, **kw):
    return tmake_mesh(n, devices="cpu", **kw)


def _batch(size=32, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8),
            rng.integers(0, 16, (n,)).astype(np.int32))


def _port(tree, dtype=np.float32) -> dict:
    """A reference param-shaped tree → the port's state-dict layout, in
    ``dtype`` (``mobilenet_v2_from_jax``'s layouts, without its cast to
    float32)."""
    def leaf(a):
        a = np.asarray(a, dtype)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a
        return torch.tensor(np.ascontiguousarray(a))
    return {jax_weights.state_key(p): leaf(jax_weights._get(tree, p))
            for p in mobilenet_v2.jax_leaf_paths()}


def _model(jp_np, dtype=torch.float32) -> mobilenet_v2.MobileNetV2:
    m = mobilenet_v2.MobileNetV2(num_classes=16, generator=torch.Generator().manual_seed(0))
    m.load_state_dict(mobilenet_v2.mobilenet_v2_from_jax(jp_np))
    return m.to(dtype)


def _norm_rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return float(np.sqrt(num / sum(float((b[k].double() ** 2).sum()) for k in b)))


def _jax_state(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), tree)


def _jax_step_from(step, opt0, mesh, p_np, o_np, dtype, batch):
    """One reference step from a (params, momentum) state given as numpy
    trees → (loss, params, momentum) in the port's layout."""
    p = jax.device_put(_jax_state(p_np, dtype), jtrain.param_shardings(mesh, p_np))
    o = (opt0[0]._replace(trace=_jax_state(o_np, dtype)),) + tuple(opt0[1:])
    p, o, loss = step(p, o, *batch)
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    return float(loss), _port(p, np_dtype), _port(o[0].trace, np_dtype)


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's steps on its (1, 8) mesh. ``f32``: its float32
    steps, and from each float32 state its float64 step (the float32
    error's yardstick); ``f64``: its float64 steps. For step k the state
    before, the results."""
    jp_np = jax.tree_util.tree_map(
        np.asarray, jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16))
    batch = tuple(jnp.asarray(x) for x in _batch())
    mesh = jmake_mesh(8, axes=("dp", "tp"), shape=REF_MESH)
    step, p, o = jtrain.make_train_step(mesh, _jax_state(jp_np, jnp.float32), LR)
    f32 = []
    for _ in range(STEPS):
        before = tuple(jax.tree_util.tree_map(np.asarray, t) for t in (p, o[0].trace))
        p, o, loss = step(p, o, *batch)
        f32.append({"before": before, "jax32": (float(loss), _port(p), _port(o[0].trace))})
    f64 = []
    with jax.enable_x64(True):
        step64, p, o = jtrain.make_train_step(mesh, _jax_state(jp_np, jnp.float64), LR,
                                              compute_dtype=jnp.float64)
        opt0 = jax.tree_util.tree_map(np.asarray, o)
        for rec in f32:
            rec["jax64"] = _jax_step_from(step64, opt0, mesh, *rec["before"], jnp.float64, batch)
        for _ in range(STEPS):
            before = tuple(jax.tree_util.tree_map(np.asarray, t) for t in (p, o[0].trace))
            p, o, loss = step64(p, o, *batch)
            f64.append({"before": before, "jax64": (float(loss), _port(p, np.float64),
                                                    _port(o[0].trace, np.float64))})
    return jp_np, f32, f64


def _port_step(mesh_shape, jp_np, dtype=torch.float32):
    mesh = make_mesh(int(np.prod(mesh_shape)), axes=("dp", "tp"), shape=mesh_shape)
    return train.make_train_step(mesh, _model(jp_np, dtype), LR, compute_dtype=dtype)


def _run_from(step, before, dtype=np.float32):
    """One port step from a reference (params, momentum) state → (loss,
    params, momentum) gathered."""
    params, opt, loss = step(_port(before[0], dtype), _port(before[1], dtype),
                             *(torch.tensor(x) for x in _batch()))
    return (float(loss), {k: v.full() for k, v in params.items()},
            {k: v.full() for k, v in opt.items()})


def _errors(got, ref, before):
    """(loss, momentum tree, update) errors of a step's results against a
    reference step's, the last two as relative norms."""
    upd = lambda p: {k: p[k].double() - before[k].double() for k in before}  # noqa: E731
    return (abs(got[0] - ref[0]), _norm_rel(got[2], ref[2]),
            _norm_rel(upd(got[1]), upd(ref[1])))


def _assert_leaves_close(got: dict, ref: dict, rtol: float, floor: float, what: str):
    scale = max(float(v.abs().max()) for v in ref.values())
    for name, want in ref.items():
        err = float((got[name] - want).abs().max())
        assert err <= rtol * float(want.abs().max()) + floor * scale, (what, name, err)


def test_two_steps_match_jax(jax_steps):
    """float32: the port's steps on (2, 4) against the reference's float64
    step from the same state, within twice the reference's own float32
    error (module docstring); the leaves are the reference's one to one,
    and mean and var get no gradient and stay where they are."""
    jp_np, f32, _ = jax_steps
    step, _, _ = _port_step((2, 4), jp_np)
    envelope = []
    for rec in f32:
        before = _port(rec["before"][0], np.float64)
        envelope.append(_errors(rec["jax32"], rec["jax64"], before))
    bound = [2 * max(e[i] for e in envelope) for i in range(3)]
    for k, rec in enumerate(f32):
        got = _run_from(step, rec["before"])
        before = _port(rec["before"][0], np.float64)
        assert np.isfinite(got[0])
        errs = _errors(got, rec["jax64"], before)
        assert all(e <= b for e, b in zip(errs, bound)), (k, errs, bound)
        params, mom = got[1], got[2]
        assert set(params) == set(rec["jax32"][1])
        for name in params:
            if name.endswith((".mean", ".var")):
                assert torch.equal(params[name], _port(rec["before"][0])[name])
                assert not mom[name].any()


def test_two_steps_match_jax_float64(jax_steps):
    """float64: every leaf of the parameters and the momentum after each of
    two steps on (2, 4) against the reference's float64 step from the same
    state, at the bounds of the module docstring."""
    jp_np, _, f64 = jax_steps
    step, _, _ = _port_step((2, 4), jp_np, torch.float64)
    for k, rec in enumerate(f64):
        loss, params, mom = _run_from(step, rec["before"], np.float64)
        l64, p64, m64 = rec["jax64"]
        assert params["stem.weight"].dtype == torch.float64
        assert abs(loss - l64) <= 1e-7 * abs(l64), (k, loss, l64)
        _assert_leaves_close(params, p64, 5e-7, 1e-14, ("params", k))
        _assert_leaves_close(mom, m64, 5e-7, 1e-14, ("momentum", k))


def test_update_rule_is_optax_sgd_momentum():
    """torch.optim.SGD(momentum=0.9, dampening=0) from a zero buffer is
    optax.sgd(momentum=0.9): trace ← g + 0.9·trace, p ← p − lr·trace."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(3)]
    tx = optax.sgd(LR, momentum=0.9)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.SGD([tp], lr=LR, momentum=0.9, dampening=0)
    opt.state[tp]["momentum_buffer"] = torch.zeros(64)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(opt.state[tp]["momentum_buffer"].numpy(),
                                   np.asarray(st[0].trace), atol=1e-6)


def test_dp2_equals_dp1(jax_steps):
    """dp = 2 takes the global batch's moments, so it is the model dp = 1
    is: in float64, from each of the reference's states, every leaf of the
    parameters and momentum of (2, 4) within 1e-10 of (1, 1)'s, plus 1e-14
    of the tree's largest (readings 9.8e-12 and 3.5e-16: the order of the
    sums); per-position moments (each row
    normalized by its own 2 images, a different model) move the loss far
    outside float32's rounding."""
    jp_np, _, f64 = jax_steps
    steps = {shape: _port_step(shape, jp_np, torch.float64)[0] for shape in ((2, 4), (1, 1))}
    for k, rec in enumerate(f64):
        (l2, p2, m2), (l1, p1, m1) = (_run_from(steps[s], rec["before"], np.float64)
                                      for s in ((2, 4), (1, 1)))
        assert abs(l2 - l1) <= 1e-7 * abs(l1), (k, l2, l1)
        _assert_leaves_close(p2, p1, 1e-10, 1e-14, ("params", k))
        _assert_leaves_close(m2, m1, 1e-10, 1e-14, ("momentum", k))
    images, labels = (torch.tensor(x) for x in _batch())
    model = _model(jp_np)
    model.load_state_dict(_port(f64[1]["before"][0]))
    with torch.no_grad():
        whole = float(train.loss_fn(model, images, labels))
        per_row = np.mean([float(train.loss_fn(model, images[i:i + 2], labels[i:i + 2]))
                           for i in (0, 2)])
    assert abs(per_row - whole) > 1e-3 * abs(whole)


def test_reference_dp_tp_mesh_scales_depthwise_gradients(jax_steps):
    """The reference's defect that sets its comparison mesh: on (2, 4) its
    first momentum (the gradient) of every depthwise conv weight is 4× its
    (1, 8) step's, the rest about equal; the port's (2, 4) step is not
    scaled."""
    jp_np, f32, _ = jax_steps
    step, p, o = jtrain.make_train_step(jmake_mesh(8, axes=("dp", "tp"), shape=(2, 4)),
                                        _jax_state(jp_np, jnp.float32), LR)
    _, o, _ = step(p, o, *(jnp.asarray(x) for x in _batch()))
    ref, ours = _port(o[0].trace), f32[0]["jax32"][2]
    port = _run_from(_port_step((2, 4), jp_np)[0], f32[0]["before"])[2]

    def ratio(g, name):
        b = ours[name].double()
        return float((g[name].double() * b).sum() / (b * b).sum())

    dw = [n for n in ours if n.endswith(".dw.weight")]
    assert len(dw) == 17
    for name in dw:
        assert 3.9 < ratio(ref, name) < 4.1, name
        assert 0.9 < ratio(port, name) < 1.1, name
    for name in ("stem.weight", "blocks.5.expand.weight", "head.weight", "classifier.weight"):
        assert 0.9 < ratio(ref, name) < 1.1, name


def test_tp_weights_are_split_over_positions(jax_steps):
    """The head conv's 1280 channels and its batch-norm vectors, and the
    classifier's 1280 feature columns, lie as 320-wide pieces on the four
    tp positions (copies on the two dp rows); every other leaf is a copy
    at every position, and after a step the copies stay equal."""
    jp_np, _, _ = jax_steps
    step, params, opt = _port_step((2, 4), jp_np)
    full = _port(jp_np)
    for name, dim in (("head.weight", 0), ("head.scale", 0), ("head.var", 0),
                      ("classifier.weight", 1)):
        st = params[name]
        for (i, j), piece in st.local():
            assert piece.shape[dim] == 320
            np.testing.assert_array_equal(piece.detach().numpy(),
                                          full[name].narrow(dim, 320 * j, 320).numpy())
            assert piece is not st.pieces[1 - i, j]
        assert tuple(opt[name].pieces[0, 0].shape) == tuple(st.pieces[0, 0].shape)
    assert all(tuple(p.shape) == tuple(full["stem.weight"].shape)
               for _, p in params["stem.weight"].local())
    params, opt, _ = step(params, opt, *(torch.tensor(x) for x in _batch()))
    for name in ("stem.weight", "blocks.3.dw.scale", "classifier.bias"):
        pieces = [p for _, p in params[name].local()]
        assert all(torch.equal(pieces[0], p) for p in pieces[1:]), name
    assert not torch.equal(params["stem.weight"].pieces[0, 0], full["stem.weight"])


def test_train_forward_matches_jax_and_leaves_the_model_as_it_was():
    """The single-device train-mode forward (batch moments) against the
    reference's ``apply(train=True)`` at 64×64, where it is well
    conditioned (1e-4); a train step never changes the caller's model, and
    its folded inference forward is bit for bit what it was."""
    jp = jmobilenet.init_params(jax.random.PRNGKey(1), num_classes=16)
    model = _model(jax.tree_util.tree_map(np.asarray, jp))
    images, labels = _batch(size=64, seed=4)
    with torch.no_grad():
        got = mobilenet_v2.train_forward(model, torch.tensor(images)).numpy()
        infer = model(torch.tensor(images))
    ref = np.asarray(jax.jit(lambda p, x: jmobilenet.apply(p, x, train=True))(
        jp, jnp.asarray(images)))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step, params, opt = train.make_train_step(make_mesh(8, axes=("dp", "tp")), model, LR)
    step(params, opt, *(torch.tensor(x) for x in _batch()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        assert torch.equal(model(torch.tensor(images)), infer)
