"""The port's training math against the JAX package's, on CPU: flax-style
init, the loss, its gradients, one optimizer step (clip, Adam, EMA), the
amp loss, and checkpoints / hparams / train state in both directions.
(tests/test_torch_trainer.py holds the trainer, the CLI and the lr
schedules.)

t and the noise cannot come from the same random bits in both frameworks,
so the loss takes them as arguments in the port and is composed here from
the JAX package's public pieces with the same t and noise (the lines of
`DiffusionPolicy.loss` with its two draws replaced). Policies run at
model_width=8 with the r5blend horizons; weights made by the JAX package's
init (plus seeded noise) go to the port through the weight bridge.

Tolerances:
- loss: 1e-5 relative (two f32 U-Nets differ by ~4e-6 in eps, ROADMAP.md
  Queue 3 item 3).
- U-Net gradients, Adam's mu and nu: 1e-4 of each tensor's largest |value|
  (the eps difference, carried back through ~60 layers). The attention key
  biases' gradients are zero in exact arithmetic (a shift of a row of
  scores leaves the softmax as it is); there both packages return rounding
  noise, held below 1e-6 of the largest gradient of all.
- Adam's first update is g / (|g| + 1e-8) * lr: where g is ~0, a
  rounding-level difference in g flips it by up to 2 lr, and its slope in
  g, 1e-8 / (|g| + 1e-8)**2, is large wherever |g| is near 1e-8 (as when
  the clip is inactive and the gradients are small). So the update over lr
  is held at 1e-3 only where |g| > 1e-3 * max |g| of its tensor and where
  that slope times the gradients' own tolerance, 1e-4 * max |g|, stays
  within 1e-3 (g as Adam gets it, after the clip).
- EMA: exactly e*d + p*(1-d) in float32 on the port's own numbers, and
  within 1e-6 of the JAX EMA (the new params differ by at most 2 lr).
- amp loss: within TOL_ULPS = 6 bf16 ulps of its value, the rule of
  tests/test_torch_amp.py.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from state_policy_diffusionmodel_tpu import diffusion as jd
from state_policy_diffusionmodel_tpu.diffusion import schedules as js
from state_policy_diffusionmodel_tpu.train import checkpoints as jck
from state_policy_diffusionmodel_tpu.train import loop as jl
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.data import dataset as tds
from state_policy_diffusionmodel_torch.params_from_jax import (
    params_from_jax, params_to_jax,
)
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.train import loop as tl

CFG = dict(noise_steps=1000, obs_horizon=10, pred_horizon=30,
           inpaint_horizon=1, model="UNet_Film", vision_encoder="autoencoder",
           step_size=5, model_width=8)
B, LR, DECAY = 4, 4e-4, 0.9995
TOL_ULPS, BF16_ULP = 6, 2 ** -7
ZERO_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work: pytest-xdist runs
    several test processes on the host's cores, and oversubscribed OpenMP
    pools spin (a fit here measured >10x slower with the default count
    than alone); the checks do not depend on the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss(jpol, params, batch, t, noise):
    """`DiffusionPolicy.loss` with t and the noise given."""
    cond = jpol.obs_cond(params, batch)
    inpaint = jpol.inpaint_vector(batch)
    vec = jnp.concatenate([inpaint, jpol.prediction_vector(batch)], axis=1)
    noise = noise.astype(vec.dtype)
    x_noisy = jpol._constrain(js.add_noise(jpol.schedule, vec, noise, t),
                              inpaint)
    eps = jpol.unet.apply({"params": params["unet"]}, x_noisy[..., None], t,
                          cond)[..., 0]
    return jnp.mean((noise.astype(jnp.float32) - eps.astype(jnp.float32))
                    ** 2)


def _bf16(v):
    return v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v


@pytest.fixture(scope="module")
def setup():
    """The width-8 pair, one batch, t and noise, and JAX's compiled
    value_and_grad (shared by every test of the module)."""
    jpol = jd.DiffusionPolicy(jd.PolicyConfig(**CFG))
    init = jpol.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda p: np.asarray(p, np.float32)
                          + (rng.normal(size=p.shape) * 0.02)
                          .astype(np.float32), init)
    tpol = td.DiffusionPolicy(td.PolicyConfig(**CFG), device="cpu")
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    batch = {"position": f(B, 40, 2), "velocity": f(B, 40, 2),
             "action": f(B, 40, 3),
             "image": rng.uniform(0, 1, (B, 10, 96, 96, 3))
             .astype(np.float32)}
    t = rng.integers(0, 1000, B).astype(np.int32)
    noise = f(B, 31, 5)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b, t, n: _jax_loss(jpol, p, b, t, n)))
    return dict(jpol=jpol, init=init, params=params, tpol=tpol, batch=batch,
                t=t, noise=noise, vg=vg, update=jax.jit(_jax_update),
                opt_init=jax.jit(jl.make_optimizer(
                    jl.TrainConfig(lr=LR)).init))


def _jax_update(params, grads):
    """One step of the JAX train step after its gradients: (new params,
    opt_state, EMA). Run on the raveled tree (one leaf: every op but the
    clip's global norm is elementwise, so the numbers are the tree's, and
    XLA compiles one leaf in a fraction of the time of ~200)."""
    opt = jl.make_optimizer(jl.TrainConfig(lr=LR))
    st = opt.init(params)
    st[1].hyperparams["learning_rate"] = jnp.asarray(LR)
    updates, st = opt.update(grads, st, params)
    new = optax.apply_updates(params, updates)
    return new, st, jl.ema_update(params, new, DECAY)


def _ravel(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(v, np.float32))
                           for v in jax.tree_util.tree_leaves(tree)])


def _unravel(vec, like):
    """`vec` split into a tree shaped as `like` (numpy: eager JAX would
    compile a slice per leaf)."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    vec = np.asarray(vec)
    out, i = [], 0
    for leaf in leaves:
        n = np.size(leaf)
        out.append(vec[i:i + n].reshape(np.shape(leaf)))
        i += n
    return jax.tree_util.tree_unflatten(treedef, out)


def _jax_step(s, params, grads):
    """(new params, optax state tree, EMA) of one JAX step: the raveled
    update unraveled into the JAX train step's trees."""
    new, flat, ema = s["update"](_ravel(params), _ravel(grads))
    tree = s["opt_init"](params)
    adam = flat[1].inner_state[0]
    inner = (tree[1].inner_state[0]._replace(
        count=adam.count, mu=_unravel(adam.mu, params),
        nu=_unravel(adam.nu, params)),) + tuple(tree[1].inner_state[1:])
    st = (tree[0], tree[1]._replace(count=flat[1].count,
                                    hyperparams=flat[1].hyperparams,
                                    inner_state=inner))
    return (_unravel(new, params), jax.device_get(st),
            _unravel(ema, params))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err,
                                                         np.abs(want).max())


# ---------------------------------------------------------------------------
# init, loss, gradients
# ---------------------------------------------------------------------------

def test_init_params_keys_shapes_and_spread(setup):
    """The port's fresh params name and shape every leaf of the JAX init
    tree, and every tensor of >= 1,024 elements has its std within 15% of
    JAX's (the sample std of 1,024 draws lies ~2% from the true one); the
    norm scales are ones and the biases zeros, as flax's."""
    got = params_to_jax(setup["tpol"].init_params(
        torch.Generator().manual_seed(3)))
    want = _keyed(setup["init"])
    assert sorted(got) == sorted(want)
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.size >= 1024:
            assert abs(g.std() / w.std() - 1) < 0.15, (k, g.std(), w.std())
            checked += 1
        if "scale" in k:
            assert np.all(g == 1) and np.all(w == 1), k
        if k.endswith("['bias']") or "norm_bias" in k or "mid_bias" in k:
            assert np.all(g == 0) and np.all(w == 0), k
    assert checked > 20


def test_loss_matches_jax(setup):
    s = setup
    want = float(s["vg"](s["params"], s["batch"], s["t"], s["noise"])[0])
    tparams = params_from_jax(s["params"], "cpu")
    got = s["tpol"].loss(tparams, _torch_batch(s["batch"]),
                         t=torch.from_numpy(s["t"]).long(),
                         noise=torch.from_numpy(s["noise"]))
    assert got.dtype == torch.float32 and got.shape == ()
    _rel_close(got.item(), want, 1e-5)
    # the draws: t in [0, noise_steps), noise of the vector's shape
    gen = torch.Generator().manual_seed(0)
    drawn = s["tpol"].loss(tparams, _torch_batch(s["batch"]), gen)
    assert torch.isfinite(drawn)


def _zero_grads(grads):
    """The U-Net tensors whose gradient is zero in exact arithmetic: the
    attention key biases (softmax ignores a shift shared by a row of
    scores). Both packages return rounding noise there, below ZERO_REL of
    the largest gradient of all."""
    top = max(np.abs(v).max() for v in grads.values())
    zero = {k for k, v in grads.items() if k.startswith("['unet']")
            and np.abs(v).max() < ZERO_REL * top}
    assert zero and all("['key']['bias']" in k for k in zero), zero
    return zero


def _port_grads(s, params):
    tparams = params_from_jax(params, "cpu")
    loss = s["tpol"].loss(tparams, _torch_batch(s["batch"]),
                          t=torch.from_numpy(s["t"]).long(),
                          noise=torch.from_numpy(s["noise"]))
    loss.backward()
    grads = {p: p.grad for m in tparams.values() for p in m.parameters()
             if p.grad is not None}
    assert all(p.grad is None for p in tparams["encoder"].parameters())
    return params_to_jax({"unet": tparams["unet"]}, grads)


def test_unet_gradients_match_jax(setup):
    s = setup
    _, jgrads = s["vg"](s["params"], s["batch"], s["t"], s["noise"])
    want = _keyed(jgrads)
    got = _port_grads(s, s["params"])
    assert set(got) == {k for k in want if k.startswith("['unet']")}
    assert all(np.all(v == 0) for k, v in want.items()
               if k.startswith("['encoder']"))
    zero = _zero_grads(want)
    top = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        if k in zero:
            assert np.abs(g).max() < ZERO_REL * top, k
            continue
        _rel_close(g, want[k], 1e-4, k)


@pytest.mark.parametrize("clip_active", [True, False])
def test_one_optimizer_step_matches_jax(setup, clip_active):
    """clip, Adam and EMA from the same params, batch, t and noise. With the
    U-Net's output conv scaled by 1e-3 the global norm falls below 0.5 and
    the clip leaves the gradients as they are; as initialized it is far
    above."""
    s = setup
    params = copy.deepcopy(s["params"])
    if not clip_active:
        params["unet"]["Conv_0"]["kernel"] = (
            params["unet"]["Conv_0"]["kernel"] * np.float32(1e-3))
    _, jgrads = s["vg"](params, s["batch"], s["t"], s["noise"])
    gnorm = float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                              for v in _keyed(jgrads).values())))
    assert (gnorm > 0.5) == clip_active, gnorm
    jnew, st, jema = _jax_step(s, params, jgrads)

    tparams = params_from_jax(params, "cpu")
    tema = copy.deepcopy(tparams)
    e0 = params_to_jax(tema)
    topt = tl.make_optimizer(tl.TrainConfig(lr=LR), tparams)
    step = tl.make_train_step(s["tpol"], tparams, topt, ema=tema,
                              ema_decay=DECAY)
    loss = step(_torch_batch(s["batch"]), LR,
                t=torch.from_numpy(s["t"]).long(),
                noise=torch.from_numpy(s["noise"]))
    assert loss.shape == () and not loss.requires_grad

    g = _keyed(jgrads)
    zero = _zero_grads(g)
    got_state, want_state = topt.state_to_jax(), _keyed(st)
    assert sorted(got_state) == sorted(want_state)
    for k, w in want_state.items():
        if ".mu[" in k or ".nu[" in k:
            if k[len(tl._ADAM) + 2:] not in zero:
                _rel_close(got_state[k], w, 1e-4, k)
        else:
            np.testing.assert_array_equal(got_state[k], w, err_msg=k)
    p0, p1, pj = _keyed(params), params_to_jax(tparams), _keyed(jnew)
    clip = min(1.0, 0.5 / gnorm)
    for k in p0:
        ge = np.abs(g[k]) * clip               # what Adam gets
        gmax = ge.max()
        big = (ge > 1e-3 * gmax) & (
            tl.EPS * 1e-4 * gmax / (ge + tl.EPS) ** 2 <= 1e-3)
        if k.startswith("['encoder']"):
            np.testing.assert_array_equal(p1[k], p0[k])
            continue
        if k in zero:        # the update's sign is the rounding noise's
            continue
        np.testing.assert_allclose(((p1[k] - p0[k]) / LR)[big],
                                   ((pj[k] - p0[k]) / LR)[big], rtol=0,
                                   atol=1e-3, err_msg=k)
    ema, je = params_to_jax(tema), _keyed(jema)
    d = np.float32(DECAY)
    for k in ema:
        want = e0[k] * d + p1[k] * (np.float32(1) - d)
        np.testing.assert_array_equal(ema[k], want, err_msg=k)
        np.testing.assert_allclose(ema[k], je[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_amp_loss_matches_jax(setup):
    """JAX's amp loss (params and batch cast to bf16, loss in f32) against
    the port's train step's (`amp_params`)."""
    s = setup
    jb = {k: _bf16(jnp.asarray(v)) for k, v in s["batch"].items()}
    jp = jax.tree.map(lambda v: _bf16(jnp.asarray(v)), s["params"])
    want = float(jax.jit(lambda p, b, t, n: _jax_loss(
        s["jpol"], p, b, t, n))(jp, jb, s["t"], s["noise"]))
    want32 = float(s["vg"](s["params"], s["batch"], s["t"], s["noise"])[0])
    tparams = params_from_jax(s["params"], "cpu")
    tb = {k: v.bfloat16() for k, v in _torch_batch(s["batch"]).items()}
    got = s["tpol"].loss(tl.amp_params(tparams), tb,
                         t=torch.from_numpy(s["t"]).long(),
                         noise=torch.from_numpy(s["noise"]))
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= TOL_ULPS * BF16_ULP * abs(want)
    assert got.item() != want32          # the amp path is not the fp32 one
    got.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tparams["unet"].parameters())


# ---------------------------------------------------------------------------
# checkpoints, hparams and train state in both directions
# ---------------------------------------------------------------------------

def _stats():
    rng = np.random.default_rng(2)
    return {"position": {"min": np.float32(-4.0), "max": np.float32(5.5)},
            "velocity": {"min": rng.normal(size=2).astype(np.float32),
                         "max": rng.normal(size=2).astype(np.float32) + 3},
            "action": {"min": -np.ones(3, np.float32),
                       "max": np.ones(3, np.float32)}}


def _jax_opt_state(s, seed):
    """An optax state after one update with random U-Net gradients (zero for
    the encoder, as when it is frozen), through the module's compiled
    update."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                     s["params"])
    g["encoder"] = jax.tree.map(np.zeros_like, g["encoder"])
    return _jax_step(s, s["params"], g)[1]


def test_jax_run_dir_loads_in_the_port(setup, tmp_path, monkeypatch):
    """A run dir the JAX package writes (npz checkpoints, as it does without
    orbax) read by the port's load_run, load_checkpoint and
    load_train_state."""
    monkeypatch.setattr(jck, "ocp", None)
    s = setup
    out = str(tmp_path)
    jcfg = s["jpol"].config
    jck.save_checkpoint(out, s["params"], 3)
    ema = jax.tree.map(lambda v: v * np.float32(0.5), s["params"])
    jck.save_checkpoint(out, ema, 3, subdir="checkpoints_ema")
    jck.save_hparams(out, jcfg, jl.TrainConfig(lr=LR, ema_decay=DECAY))
    stats = _stats()
    tds.save_stats(stats, os.path.join(out, "STATS.pkl"))
    st = _jax_opt_state(s, 3)
    meta = {"epoch": 3, "lr": 2.5e-4, "best_val": float("inf"),
            "num_bad": 1, "es_wait": 0, "step": 44}
    jck.save_train_state(out, st, meta)

    for use_ema, tree in ((False, s["params"]), (True, ema)):
        pol, params, got_stats = tck.load_run(out, "cpu", ema=use_ema)
        got, want = params_to_jax(params), _keyed(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pol.config == td.PolicyConfig(**CFG)
    assert got_stats["position"]["max"] == stats["position"]["max"]

    leaves, got_meta = tck.load_train_state(out)
    assert got_meta == meta
    opt = tl.make_optimizer(tl.TrainConfig(lr=LR), params)
    opt.load_jax(leaves)
    assert opt.count == 1
    back, want = opt.state_to_jax(), _keyed(st)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_port_run_dir_loads_in_jax(setup, tmp_path):
    """A run dir the port writes read by the JAX package's load_checkpoint,
    load_hparams and load_train_state; the hparams text is what
    yaml.safe_dump writes."""
    s = setup
    out = str(tmp_path)
    tparams = params_from_jax(s["params"], "cpu")
    tck.save_checkpoint(out, tparams, 0)
    tck.save_npz(os.path.join(tck.checkpoint_dir(out, 0, "checkpoints_ema"),
                              "params.npz"), params_to_jax(tparams),
                 np.float16)
    tcfg = tl.TrainConfig(lr=LR, ema_decay=DECAY, lr_schedule="cosine",
                          insurance_dir=str(tmp_path / "ins"))
    tck.save_hparams(out, s["tpol"].config, tcfg)
    opt = tl.make_optimizer(tcfg, tparams)
    opt.load_jax(_keyed(_jax_opt_state(s, 4)))
    meta = {"epoch": 0, "lr": 4e-4, "best_val": 0.25, "num_bad": 0,
            "es_wait": 2, "step": 7}
    tck.save_train_state(out, opt.state_to_jax(), meta)

    like = jax.tree.map(np.zeros_like, s["params"])
    got = jck.load_checkpoint(tck.latest_checkpoint(out), like)
    for k, w in _keyed(s["params"]).items():
        np.testing.assert_array_equal(_keyed(got)[k], w, err_msg=k)
    half = jck.load_checkpoint(
        tck.latest_checkpoint(out, "checkpoints_ema"), like)
    for k, w in _keyed(s["params"]).items():
        np.testing.assert_array_equal(
            _keyed(half)[k], w.astype(np.float16).astype(np.float32))
    hp = jck.load_hparams(os.path.join(out, "hparams.yaml"))
    jtcfg = jl.TrainConfig(lr=LR, ema_decay=DECAY, lr_schedule="cosine",
                           insurance_dir=str(tmp_path / "ins"))
    payload = dict(dataclasses.asdict(s["jpol"].config))
    payload.update({f"train_{k}": v
                    for k, v in dataclasses.asdict(jtcfg).items()})
    payload["observation_dim"] = s["jpol"].config.observation_dim
    assert hp == payload
    with open(os.path.join(out, "hparams.yaml")) as f:
        assert f.read() == yaml.safe_dump(payload)
    like_st = _jax_opt_state(s, 5)
    jst, jmeta = jck.load_train_state(out, jax.device_get(like_st))
    assert jmeta == meta
    for k, w in opt.state_to_jax().items():
        np.testing.assert_array_equal(_keyed(jst)[k], w, err_msg=k)
