"""The port's multi-device layer on CPU: ranks are spawned processes joined
over gloo (`parallel.launch`), and each multi-rank run is held against the
same work on one process.

- `pad_to_multiple` equals the JAX function on the same batch.
- The keyed x_T (`diffusion.keyed_init_noise`) depends on each env's id
  and the frame only, bit for bit; it is uniform in [0, 1), or normal with
  the right mean and spread; for ids 0..B-1 it is the ring policy's draw
  before it was keyed.
- `rollout_constant_sharded` at 2 and 4 ranks equals the 1-rank loop
  (rewards within 1e-6, positions within 1e-5, as the JAX package's
  `tests/test_render_env.py` holds its 8-device rollout), and JAX's
  8-device `rollout_constant_sharded` within tests/test_torch_env.py's env
  tolerances (rewards equal, positions within 1e-3).
- `rollout_policy_sharded` (the JAX test's config: UNet width 8, no
  encoder, DDIM-2, 16 envs, 4 steps, render off) at 2 and 4 ranks equals
  one rank: actions within 1e-5, rewards within 1e-6.
- Two data-parallel train steps at 2 and 4 ranks equal one rank: losses
  within rtol 1e-5, params within rtol 1e-3 / atol 1e-5 (the JAX
  multi-device test's limits, `tests/test_train.py`); a 1-epoch
  `Trainer.fit` at 2 ranks writes only rank 0's run dir, ends with equal
  params on both ranks, and its run dir loads in both packages;
  `device_data` with an indivisible batch raises.
- `dryrun_multichip(2, "cpu")` runs.

One spawn a world size serves every check of that size. The spawned ranks
import this module, so it imports no JAX at module level. Every launch has
a timeout and fails rather than waits.
"""

import os

import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch import parallel
from state_policy_diffusionmodel_torch import track as TT
from state_policy_diffusionmodel_torch.data.dataset import (
    DataModule, WindowDataset,
)
from state_policy_diffusionmodel_torch.envs import vector as tv
from state_policy_diffusionmodel_torch.parallel.launch import launch
from state_policy_diffusionmodel_torch.train import checkpoints as tck
from state_policy_diffusionmodel_torch.train import loop as tl

LAUNCH_TIMEOUT = 240.0
B_ENV, N_STEPS = 16, 10
POLICY_CFG = dict(noise_steps=20, obs_horizon=3, pred_horizon=6,
                  inpaint_horizon=1, model="UNet", model_width=8,
                  vision_encoder="none", step_size=2)
TRAIN_CFG = dict(noise_steps=100, obs_horizon=2, pred_horizon=6,
                 inpaint_horizon=1, model="UNet_Film", model_width=8,
                 vision_encoder="autoencoder", step_size=1)
TRAIN_B, LR = 8, 3e-4


# ---------------------------------------------------------------------------
# the work, the same on one process and on every rank
# ---------------------------------------------------------------------------

def _bank(n=2):
    return TT.stack([TT.build(TT.make_track(s), bake=False, device="cpu")
                     for s in range(n)])


def _env_inputs():
    bank = _bank()
    tids = torch.arange(B_ENV, dtype=torch.int32) % 2
    states = tv.init_batch(bank, tids, device="cpu")
    acts = torch.tensor([0.0, 0.6, 0.0]).repeat(B_ENV, 1)
    acts[::3, 0] = -0.4
    return bank, tids, states, acts


def _policy(device="cpu"):
    """The JAX test's policy, its output conv scaled by 1e-3: at random
    init the U-Net's eps is large and every sample clips to -1 whatever
    x_T is; scaled, the actions follow x_T, so a wrong draw shows."""
    pol = td.DiffusionPolicy(td.PolicyConfig(**POLICY_CFG), device)
    params = pol.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        params["unet"].Conv_0.weight.mul_(1e-3)
    return pol, params


def _data_module():
    rng = np.random.default_rng(0)
    T = 60
    ds = WindowDataset(({
        "img": rng.integers(0, 256, (T, 96, 96, 3), dtype=np.uint8),
        "position": np.cumsum(rng.normal(size=(T, 2)), 0).astype(np.float32),
        "velocity": rng.normal(size=(T, 2)).astype(np.float32),
        "action": rng.uniform(-1, 1, (T, 3)).astype(np.float32)},
        np.asarray([T])), TRAIN_CFG["obs_horizon"], TRAIN_CFG["pred_horizon"],
        step_size=1)
    dm = DataModule(batch_size=TRAIN_B, T_obs=TRAIN_CFG["obs_horizon"],
                    T_pred=TRAIN_CFG["pred_horizon"], seed=0, step_size=1)
    dm.data_full, dm.stats = ds, ds.stats
    perm = np.random.default_rng(1).permutation(len(ds))
    dm.train_idx, dm.val_idx = perm[:3 * TRAIN_B], perm[3 * TRAIN_B:]
    return dm


def _two_steps(mesh, out_dir):
    """Two data-parallel steps through the Trainer's batch path (device
    data, t and noise drawn at the global shape): (losses (2,), params)."""
    pol = td.DiffusionPolicy(td.PolicyConfig(**TRAIN_CFG), mesh.device)
    params = pol.init_params(torch.Generator().manual_seed(0))
    cfg = tl.TrainConfig(batch_size=TRAIN_B, lr=LR, device_data=True,
                         early_stop=False)
    tr = tl.Trainer(pol, cfg, out_dir, mesh=mesh)
    dm = _data_module()
    step = tl.make_train_step(pol, params, tl.make_optimizer(cfg, params),
                              mesh=mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(7)
    losses = []
    for idx in dm.train_idx[:2 * TRAIN_B].reshape(2, TRAIN_B):
        batch, t, noise = tr._batch(dm, idx, gen)
        losses.append(step(batch, LR, t=t, noise=noise))
    losses = parallel.mean_over_ranks(torch.stack(losses), mesh)
    return losses, {k: v.detach().clone() for k, v in
                    params["unet"].state_dict().items()}


def _fit(mesh, root):
    """A 1-epoch fit on the host path with EMA, each rank naming its own
    run dir (only rank 0's may come to exist)."""
    pol = td.DiffusionPolicy(td.PolicyConfig(**TRAIN_CFG), "cpu")
    cfg = tl.TrainConfig(epochs=1, batch_size=TRAIN_B, lr=LR,
                         lr_schedule="cosine", ema_decay=0.99,
                         early_stop=False, seed=3)
    out = os.path.join(root, f"run_rank{mesh.rank}")
    res = tl.Trainer(pol, cfg, out, mesh=mesh).fit(_data_module())
    flat = torch.cat([p.detach().reshape(-1) for m in res["params"].values()
                      for p in m.parameters()])
    return {"params": flat, "history": res["history"], "out": out}


def _rank_checks(mesh, root):
    """Every multi-rank check of one world size, in one spawn."""
    out = {}
    bank, tids, states, acts = _env_inputs()
    s, roll = tv.rollout_constant_sharded(mesh, states, bank, acts, N_STEPS,
                                          render=False, track_ids=tids)
    out["constant"] = (roll.rewards, parallel.gather_rows(s.car.pos, mesh))
    # stacked per-env geometry (track_ids=None): a track an env
    bank4 = _bank(4)
    s4 = tv.init_batch(bank4, device="cpu")
    s4, roll4 = tv.rollout_constant_sharded(mesh, s4, bank4, acts[:4], 5,
                                            render=False)
    out["constant_stacked"] = (roll4.rewards,
                               parallel.gather_rows(s4.car.pos, mesh))
    pol, params = _policy()
    fn = td.make_ring_policy(pol, num_inference_steps=2, sampler="ddim")
    _, carry, a, r = tv.rollout_policy_sharded(
        mesh, params, bank, td.env_policy_fn(fn),
        td.init_ring_carry(pol, B_ENV), 4, render=False, track_ids=tids)
    out["policy"] = (a, r)
    out["policy_uid"] = carry["uid"]
    out["steps"] = _two_steps(mesh, os.path.join(root, "steps"))
    out["fit"] = _fit(mesh, root) if mesh.world_size == 2 else None
    return out


# ---------------------------------------------------------------------------
# fixtures: one spawn a world size, and the one-process reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def one(root):
    mesh = parallel.Mesh(0, 1, torch.device("cpu"))
    bank, tids, states, acts = _env_inputs()
    s, roll = tv.rollout_constant(states, bank, acts, N_STEPS, render=False,
                                  track_ids=tids, device="cpu")
    bank4 = _bank(4)
    s4, roll4 = tv.rollout_constant(tv.init_batch(bank4, device="cpu"), bank4,
                                    acts[:4], 5, render=False, device="cpu")
    pol, params = _policy()
    fn = td.make_ring_policy(pol, num_inference_steps=2, sampler="ddim")
    _, _, out = tv.rollout_policy(bank, td.env_policy(fn, params),
                                  td.init_ring_carry(pol, B_ENV), 4,
                                  render=False, track_ids=tids, device="cpu")
    return {"constant": (roll.rewards, s.car.pos),
            "constant_stacked": (roll4.rewards, s4.car.pos),
            "policy": (out.actions, out.rewards),
            "steps": _two_steps(mesh, os.path.join(root, "steps1"))}


@pytest.fixture(scope="module")
def ranks(root):
    return {n: launch(_rank_checks, n, "cpu", args=(root,),
                      timeout=LAUNCH_TIMEOUT) for n in (2, 4)}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def test_pad_to_multiple_matches_jax():
    from state_policy_diffusionmodel_tpu.parallel import mesh as jm

    rng = np.random.default_rng(0)
    for n, mult in ((5, 4), (8, 4), (7, 3), (1, 8)):
        batch = {"a": rng.normal(size=(n, 3)).astype(np.float32),
                 "b": rng.integers(0, 9, (n,))}
        got, n_got = parallel.pad_to_multiple(batch, mult)
        want, n_want = jm.pad_to_multiple(batch, mult)
        assert n_got == n_want == n
        for k in batch:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    idx, n = parallel.pad_to_multiple(np.arange(6), 4)
    assert n == 6 and idx.tolist() == [0, 1, 2, 3, 4, 5, 5, 5]
    mesh = parallel.Mesh(1, 4, torch.device("cpu"))
    got = parallel.shard_batch({"x": idx, "k": 3}, mesh)
    assert got["x"].tolist() == [2, 3] and got["k"] == 3
    with pytest.raises(ValueError, match="split"):
        parallel.shard_batch(np.arange(6), mesh)


def test_keyed_init_noise_is_independent_of_the_batch():
    shape = (31, 5)
    for uniform in (True, False):
        all16 = td.keyed_init_noise(np.arange(16), 5, shape, 0, uniform)
        tail = td.keyed_init_noise(np.arange(8, 16), 5, shape, 0, uniform)
        assert all16.dtype == np.float32 and all16.shape == (16, *shape)
        np.testing.assert_array_equal(all16[8:], tail)
        odd = td.keyed_init_noise(np.array([15, 3, 9]), 5, shape, 0, uniform)
        np.testing.assert_array_equal(odd, all16[[15, 3, 9]])
        # another frame, seed or env: another draw
        assert not np.array_equal(
            td.keyed_init_noise(np.arange(8, 16), 10, shape, 0, uniform),
            tail)
        assert not np.array_equal(
            td.keyed_init_noise(np.arange(8, 16), 5, shape, 1, uniform),
            tail)
        assert not np.array_equal(all16[0], all16[1])


def test_keyed_init_noise_is_the_unkeyed_draw_for_ids_0_to_b():
    """For uid = arange(B) the keyed draw is torch.rand((B, ...)) of the
    CPU generator seeded seed * 1_000_003 + k0, the ring policy's default
    draw before it was keyed; a given generator is left after the draw."""
    for seed, k0, B in ((0, 0, 16), (3, 25, 256)):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + k0)
        want = torch.rand((B, 31, 5), generator=gen).numpy()
        got = td.keyed_init_noise(np.arange(B), k0, (31, 5), seed, True)
        np.testing.assert_array_equal(got, want)
        mine = torch.Generator().manual_seed(seed * 1_000_003 + k0)
        td.keyed_init_noise(np.arange(B), k0, (31, 5), seed, True,
                            generator=mine)
        assert torch.equal(torch.rand(7, generator=mine),
                           torch.rand(7, generator=gen))
    with pytest.raises(ValueError, match=">= 0"):
        td.keyed_init_noise(np.array([-1]), 0, (2,))


def test_keyed_init_noise_distributions():
    u = td.keyed_init_noise(np.arange(512), 7, (31, 5), 0, True)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.std() - 12 ** -0.5) < 0.005
    z = td.keyed_init_noise(np.arange(512), 7, (31, 5), 0, False)
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 0.015 and abs(z.std() - 1.0) < 0.015
    # 79,360 draws: the share beyond 2 sigma is a normal's 4.55%
    assert abs((np.abs(z) > 2).mean() - 0.0455) < 0.004


def test_ring_policy_draws_the_keyed_noise():
    pol, params = _policy()
    seen = []
    fn = td.make_ring_policy(pol, num_inference_steps=2, seed=4)
    ref = td.make_ring_policy(pol, num_inference_steps=2, seed=4,
                              init_noise_fn=lambda uid, k0: seen.append(
                                  (uid.clone(), k0)) or torch.from_numpy(
                                  td.keyed_init_noise(
                                      uid.numpy(), k0, (7, 5), 4, True)))
    carry = td.init_ring_carry(pol, 4, env_uids=torch.tensor([9, 2, 7, 0]))
    obs = torch.zeros((4, 96, 96, 3), dtype=torch.uint8)
    pos, vel = torch.ones((4, 2)), torch.zeros((4, 2))
    a, _ = fn(params, carry, obs, pos, vel)
    b, _ = ref(params, carry, obs, pos, vel)
    assert seen[0][1] == 0 and seen[0][0].tolist() == [9, 2, 7, 0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rollout_constant_sharded_equals_one_rank(ranks, one):
    for n, outs in ranks.items():
        for key in ("constant", "constant_stacked"):
            want_r, want_p = one[key]
            for o in outs:
                got_r, got_p = o[key]
                np.testing.assert_allclose(got_r.numpy(), want_r.numpy(),
                                           atol=1e-6, rtol=0,
                                           err_msg=f"{n} ranks {key}")
                np.testing.assert_allclose(got_p.numpy(), want_p.numpy(),
                                           atol=1e-5, rtol=0)


def test_rollout_constant_sharded_matches_jax_on_8_devices(ranks):
    import jax
    import jax.numpy as jnp

    from state_policy_diffusionmodel_tpu import envs as JE
    from state_policy_diffusionmodel_tpu import parallel as jp
    from state_policy_diffusionmodel_tpu import track as JT

    bank, tids, states, acts = _env_inputs()
    jbank = JT.TrackGeometry(*(jnp.asarray(x.numpy()) for x in bank))
    jids = jnp.asarray(tids.numpy())
    js = jax.jit(JE.vector.init_batch)(jbank, jids)
    np.testing.assert_array_equal(np.asarray(js.car.pos),
                                  states.car.pos.numpy())
    js, traj = JE.vector.rollout_constant_sharded(
        jp.make_mesh(), js, jbank, jnp.asarray(acts.numpy()), N_STEPS,
        render=False, track_ids=jids)
    got_r, got_p = ranks[2][0]["constant"]
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(traj.reward))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(js.car.pos),
                               atol=1e-3, rtol=0)


def test_rollout_policy_sharded_equals_one_rank(ranks, one):
    want_a, want_r = one["policy"]
    assert tuple(want_a.shape) == (4, B_ENV, 3)
    # mostly unclipped actions that differ from env to env: they follow x_T
    assert float((want_a.abs() < 1.0).float().mean()) > 0.75
    assert float(want_a[:, :, 1].std(dim=1).min()) > 1e-2
    for n, outs in ranks.items():
        for rank, o in enumerate(outs):
            a, r = o["policy"]
            np.testing.assert_allclose(a.numpy(), want_a.numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"{n} ranks")
            np.testing.assert_allclose(r.numpy(), want_r.numpy(), atol=1e-6,
                                       rtol=0)
            # the carry keeps each env's global id
            per = B_ENV // n
            assert o["policy_uid"].tolist() == list(
                range(rank * per, (rank + 1) * per))


def test_data_parallel_steps_equal_one_rank(ranks, one):
    """The attention key biases get no gradient in exact arithmetic
    (softmax ignores a shift shared by a row of scores): their gradients
    are rounding noise, which Adam's first steps turn into updates of up
    to lr each, of either sign. They start at zero, so they are held by
    that magnitude (as tests/test_torch_train.py holds them), every other
    tensor by the JAX test's limits."""
    want_l, want_p = one["steps"]
    for n, outs in ranks.items():
        for o in outs:
            got_l, got_p = o["steps"]
            np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                                       rtol=1e-5, err_msg=f"{n} ranks")
            for k, v in want_p.items():
                if k.endswith("key.bias"):
                    for side in (got_p[k], v):
                        assert float(side.abs().max()) <= 2 * LR * 1.001, k
                    continue
                np.testing.assert_allclose(got_p[k].numpy(), v.numpy(),
                                           rtol=1e-3, atol=1e-5, err_msg=k)
            assert any(k.endswith("key.bias") for k in want_p)


def test_fit_on_two_ranks_writes_only_rank_0_and_loads_in_both(ranks):
    import jax

    from state_policy_diffusionmodel_tpu import diffusion as jd
    from state_policy_diffusionmodel_tpu.train import checkpoints as jck
    from state_policy_diffusionmodel_torch.params_from_jax import (
        params_to_jax,
    )

    r0, r1 = (o["fit"] for o in ranks[2])
    assert not os.path.exists(r1["out"])
    for p in ("checkpoints/epoch=0/params.npz",
              "checkpoints_ema/epoch=0/params.npz", "STATS.pkl",
              "hparams.yaml", "metrics.jsonl", "trainer_state/meta.yaml"):
        assert os.path.exists(os.path.join(r0["out"], p)), p
    torch.testing.assert_close(r0["params"], r1["params"], rtol=0, atol=0)
    assert r0["history"] == r1["history"]
    assert np.isfinite(r0["history"]["train_loss"]).all()
    pol, params, _ = tck.load_run(r0["out"], "cpu")
    hp = jck.load_hparams(os.path.join(r0["out"], "hparams.yaml"))
    jcfg = jd.PolicyConfig(**{k: hp[k] for k in tck._CONFIG_KEYS})
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        jd.DiffusionPolicy(jcfg).init_params, jax.random.key(0)))
    loaded = jck.load_checkpoint(tck.latest_checkpoint(r0["out"]), like)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(loaded)[0]}
    mine = params_to_jax(params)
    assert sorted(flat) == sorted(mine)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    got = torch.cat([p.detach().reshape(-1) for m in params.values()
                     for p in m.parameters()])
    torch.testing.assert_close(got, r0["params"], rtol=0, atol=0)


def test_device_data_with_an_indivisible_batch_raises(tmp_path):
    pol = td.DiffusionPolicy(td.PolicyConfig(**TRAIN_CFG), "cpu")
    mesh = parallel.Mesh(0, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible by the world size"):
        tl.Trainer(pol, tl.TrainConfig(batch_size=6, device_data=True),
                   str(tmp_path), mesh=mesh)
    # the host path pads instead
    tl.Trainer(pol, tl.TrainConfig(batch_size=6), str(tmp_path / "h"),
               mesh=mesh)
    with pytest.raises(ValueError, match="lies on"):
        tl.Trainer(pol, tl.TrainConfig(), str(tmp_path),
                   mesh=parallel.Mesh(0, 1, torch.device("meta")))


def test_make_mesh_without_a_group_is_one_process():
    mesh = parallel.make_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu") and mesh.is_main
    x = torch.arange(4.0)
    assert parallel.gather_rows(x, mesh) is x
    assert parallel.mean_over_ranks(x, mesh) is x


def test_dryrun_multichip_on_two_cpu_ranks():
    from state_policy_diffusionmodel_torch.parallel.dryrun import (
        dryrun_multichip,
    )

    outs = dryrun_multichip(2, "cpu", timeout=LAUNCH_TIMEOUT)
    assert len(outs) == 2 and np.isfinite(outs[0]["step_loss"])
    assert tuple(outs[0]["policy_actions"].shape) == (2, 4, 3)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(_fails_on_rank_1, 2, "cpu", timeout=LAUNCH_TIMEOUT)


def _fails_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank



def _card_checks(mesh):
    """The sharded policy rollout (render on: K2 in every step, K1 in the
    denoiser) and the two steps on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    bank = TT.stack([TT.build(TT.make_track(s), device=dev)
                     for s in range(2)])
    tids = torch.arange(B_ENV, dtype=torch.int32) % 2
    pol, params = _policy(dev)
    fn = td.make_ring_policy(pol, num_inference_steps=2, sampler="ddim")
    carry = td.init_ring_carry(pol, B_ENV)
    if mesh.world_size == 1:
        _, _, out = tv.rollout_policy(bank, td.env_policy(fn, params), carry,
                                      4, track_ids=tids, device=dev)
        acts = out.actions
    else:
        _, _, acts, _ = tv.rollout_policy_sharded(
            mesh, params, bank, td.env_policy_fn(fn), carry, 4,
            track_ids=tids)
    return {"actions": acts.cpu(), "steps": _two_steps_on(mesh)}


def _two_steps_on(mesh):
    losses, params = _two_steps(mesh, os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"card_steps_{os.getpid()}"))
    return losses.cpu(), {k: v.cpu() for k, v in params.items()}


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_one_process():
    """Two gloo ranks share the one card (NCCL refuses two ranks on one
    GPU): the sharded closed loop with render on and two data-parallel
    steps equal one process on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks run on the card")
    ranks = launch(_card_checks, 2, "cuda:0", backend="gloo",
                   timeout=LAUNCH_TIMEOUT)
    one = launch(_card_checks, 1, "cuda:0", backend="gloo",
                 timeout=LAUNCH_TIMEOUT)[0]
    for o in ranks:
        np.testing.assert_allclose(o["actions"].numpy(),
                                   one["actions"].numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(o["steps"][0].numpy(),
                                   one["steps"][0].numpy(), rtol=1e-5)
