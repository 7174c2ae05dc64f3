"""The port's MFU table (`cli/mfu.py`), on CPU.

- FlopCounterMode's count of one U-Net forward at model_width 8 equals an
  analytic count, exactly: 2 x the multiply-adds of every conv (nine taps
  a 3x3, whatever the padding), every dense layer and the two attention
  matmuls (q k^T and p v), read off the module tree with forward hooks.
- The rows carry the JAX tool's fields; the peak comes from the card's
  name, `--peak` overrides it, an unknown card raises.
- `slow`: at the reference width (64) and one sample, the port's count
  beside the JAX tool's `cost_analysis()` count of the same forward; XLA
  also counts elementwise work, so the JAX count is the larger (printed;
  PERF.md quotes it).
"""

import json

import pytest
import torch

from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.cli import mfu
from state_policy_diffusionmodel_torch.models import layers

from test_torch_policy import torch_threads

_torch_threads = torch_threads(2)

JAX_ROW = {"program", "gflops", "ms", "tflops_per_sec", "mfu_pct"}


def analytic_flops(unet, run) -> int:
    """2 x multiply-adds of run()'s convs and matmuls, from the shapes
    that reach each layer."""
    total = [0]

    def conv3x3(mod, inp, out):
        B, H, W, cin = inp[0].shape
        total[0] += 2 * B * H * W * 9 * cin * mod.weight.shape[0]

    def double_conv(mod, inp, out):
        B, H, W, cin = inp[0].shape
        mid, cout = mod.conv1_kernel.shape[0], mod.conv2_kernel.shape[0]
        total[0] += 2 * B * H * W * 9 * (cin * mid + mid * cout)

    def dense(mod, inp, out):
        rows = out.numel() // mod.out_features
        total[0] += 2 * rows * mod.in_features * mod.out_features

    def conv(mod, inp, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total[0] += 2 * out.numel() * k

    def mha(mod, inp, out):
        B, T, _ = inp[0].shape
        C = mod.query.out_features
        total[0] += 2 * 2 * B * T * T * C        # q k^T and p v

    hooks = {layers.Conv3x3: conv3x3, layers.DoubleConv: double_conv,
             layers.Dense: dense, layers.Conv: conv, layers._MHA: mha}
    handles = [m.register_forward_hook(hooks[type(m)])
               for m in unet.modules() if type(m) in hooks]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counted_flops_equal_the_analytic_count(dtype):
    cfg = td.PolicyConfig(model_width=8)
    policy = td.DiffusionPolicy(cfg, "cpu")
    params = policy.init_params(torch.Generator().manual_seed(0))
    B = 4
    unet = params["unet"].to(dtype)
    x = torch.zeros((B, cfg.horizon, 5, 1), dtype=dtype)
    t = torch.zeros((B,), dtype=torch.int64)
    cond = torch.zeros((B, cfg.obs_horizon * cfg.observation_dim),
                       dtype=dtype)
    run = lambda: unet(x, t, cond)
    with torch.no_grad():
        counted = mfu.count_flops(run)
        want = analytic_flops(unet, run)
    assert counted == want
    if dtype == torch.bfloat16:
        # the table's row: the same forward on a bf16 copy of the params
        with torch.no_grad():
            assert mfu.count_flops(mfu.denoiser_forward(policy, params, B)) \
                == want


def test_rows_have_the_jax_fields(tmp_path, monkeypatch):
    out = mfu.main(["--device", "cpu", "--model_width", "8", "--batches",
                    "2,3", "--train_batch", "2", "--peak", "1e12", "--out", str(tmp_path / "m.json")])
    with open(tmp_path / "m.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(out))
    assert {"device", "peak_flops", "rows"} <= set(saved)
    assert [r["program"] for r in saved["rows"]] == [
        "denoiser fwd bf16 B=2 w=8", "denoiser fwd bf16 B=3 w=8",
        "train step fp32 B=2 w=8 (w/ encoder)"]
    for r in saved["rows"]:
        assert set(r) == JAX_ROW
        assert r["gflops"] > 0 and r["ms"] > 0
        assert r["tflops_per_sec"] == pytest.approx(
            r["gflops"] / r["ms"])
        assert r["mfu_pct"] == pytest.approx(100 * r["tflops_per_sec"])
    # the forward's count is linear in the batch
    g2, g3 = (r["gflops"] for r in saved["rows"][:2])
    assert g3 == pytest.approx(1.5 * g2, rel=1e-12)
    # amp's train step counts the same matmuls as fp32's
    amp = mfu.mfu_rows("cpu", (), 2, amp=True, model_width=8, repeats=1)
    assert amp["rows"][0]["program"] == "train step amp-bf16 B=2 w=8 " \
        "(w/ encoder)"
    assert amp["rows"][0]["gflops"] == pytest.approx(
        saved["rows"][2]["gflops"], rel=1e-12)
    assert amp["rows"][0]["mfu_pct"] is None      # no peak on the CPU


def test_peak_from_the_card_name(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_flops(cuda) == 989.5e12
    assert mfu.peak_flops(cuda, "5e14") == 5e14
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Other GPU")
    with pytest.raises(ValueError, match="--peak"):
        mfu.peak_flops(cuda)
    assert mfu.peak_flops(cuda, 1e15) == 1e15
    assert mfu.peak_flops(torch.device("cpu")) is None


@pytest.mark.slow
def test_width_64_count_beside_jax_cost_analysis():
    import jax
    import jax.numpy as jnp

    from state_policy_diffusionmodel_tpu import diffusion as jd

    cfg = td.PolicyConfig()
    policy = td.DiffusionPolicy(cfg, "cpu")
    params = policy.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = mfu.count_flops(mfu.denoiser_forward(policy, params, 1))
    jpol = jd.DiffusionPolicy(jd.PolicyConfig())
    jparams = jpol.init_params(jax.random.key(0))
    p = jax.tree.map(lambda v: v.astype(jnp.bfloat16)
                     if v.dtype == jnp.float32 else v, jparams["unet"])
    x = jnp.zeros((1, cfg.horizon, cfg.prediction_dim, 1), jnp.bfloat16)
    t = jnp.zeros((1,), jnp.int32)
    cond = jnp.zeros((1, cfg.obs_horizon * cfg.observation_dim),
                     jnp.bfloat16)
    fwd = jax.jit(lambda p, x, t, c: jpol.unet.apply({"params": p}, x, t, c))
    ca = fwd.lower(p, x, t, cond).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    xla = float(ca["flops"])
    print(f"\nUNet_Film width 64, one sample, bf16 forward: port "
          f"FlopCounterMode {port / 1e9:.4f} GFLOP, JAX cost_analysis "
          f"{xla / 1e9:.4f} GFLOP, ratio {xla / port:.4f}")
    assert port < xla
