"""``--bench attention`` of the port's bench CLI on the CPU, against the
JAX harness's attention bench.

The timed function of each impl and mode runs on the bench's own inputs
(numpy from a seed, float32) beside the JAX function on the same arrays:
``flash_attention`` (the Pallas kernels in interpret mode, as the JAX
package's tests run them on the CPU) or ``attention_reference``, and for
``grad`` ``jax.grad`` of the sum with dq + dk + dv folded, at 1e-5.  The
FLOP count and payload keys are the JAX bench's, the block search runs
once, bad arguments raise as in JAX, and the CLI refuses to run without
a card unless asked for the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flextree_tpu.bench import harness as jharness
from flextree_tpu.ops.pallas_attention import flash_attention as jflash
from flextree_tpu.parallel.ring_attention import attention_reference as jref
from flextree_tpu_torch.bench import harness
from flextree_tpu_torch.bench.__main__ import main as bench_main

SMALL = dict(batch=1, seq_len=32, heads=2, head_dim=16, dtype="float32",
             device="cpu")
CLI_SMALL = ["--device", "cpu", "--batch", "1", "--seq-len", "32", "--heads",
             "2", "--head-dim", "16", "--attn-dtype", "float32"]


def jax_core(cfg):
    if cfg.impl == "flash":
        return lambda q, k, v: jflash(q, k, v, causal=True,
                                      block_q=cfg.block_q,
                                      block_k=cfg.block_k,
                                      variant=cfg.variant, interpret=True)
    return lambda q, k, v: jref(q, k, v, causal=True)


@pytest.mark.parametrize("mode", ("fwd", "grad"))
@pytest.mark.parametrize("impl", ("flash", "reference"))
def test_timed_function_matches_jax(impl, mode):
    cfg = harness.AttentionBenchConfig(**SMALL, impl=impl, mode=mode)
    fn, qkv = harness.attention_bench_call(cfg)
    got = fn(*qkv).numpy()
    args = [jnp.asarray(x.numpy()) for x in qkv]
    core = jax_core(cfg)
    if mode == "grad":
        dq, dk, dv = jax.grad(lambda q, k, v: core(q, k, v).sum(),
                              argnums=(0, 1, 2))(*args)
        want = dq + dk + dv
    else:
        want = core(*args)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stock_is_sdpa_in_its_own_layout():
    cfg = harness.AttentionBenchConfig(**SMALL, impl="stock")
    fn, (q, k, v) = harness.attention_bench_call(cfg)
    assert q.shape == (1, 2, 32, 16)  # (B, H, T, D)
    ref = harness.attention_bench_call(
        dataclasses.replace(cfg, impl="reference"))[0]
    bthd = [x.transpose(1, 2) for x in (q, k, v)]
    np.testing.assert_allclose(fn(q, k, v).transpose(1, 2).numpy(),
                               ref(*bthd).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ("fwd", "grad"))
def test_flops_and_payload_keys_are_the_jax_benchs(mode):
    jcfg = jharness.AttentionBenchConfig(
        batch=1, seq_len=32, heads=2, head_dim=16, dtype="float32",
        impl="reference", mode=mode, timing="chained", repeat=1)
    jrep = jharness.run_attention_bench(jcfg)
    cfg = harness.AttentionBenchConfig(**SMALL, impl="reference", mode=mode,
                                       timing="chained", repeat=1)
    assert harness.attention_flops(cfg) == pytest.approx(
        jrep.tflops * jrep.per_call_s * 1e12, rel=1e-9)
    rep = harness.run_attention_bench(cfg)
    assert set(jrep.payload()) <= set(rep.payload())
    assert rep.payload()["device"] == "cpu" and rep.mfu is None
    fields = {f.name for f in dataclasses.fields(jharness.AttentionBenchConfig)}
    assert fields | {"device"} == {
        f.name for f in dataclasses.fields(harness.AttentionBenchConfig)}
    for name in fields:
        assert getattr(harness.AttentionBenchConfig, name) == \
            getattr(jharness.AttentionBenchConfig, name)
    # the flash backward's structure is the JAX kernels': 4.5x the forward
    flash = dataclasses.replace(cfg, impl="flash")
    assert harness.attention_flops(dataclasses.replace(flash, mode="grad")) \
        == 4.5 * harness.attention_flops(dataclasses.replace(flash,
                                                             mode="fwd"))


def test_autotune_runs_once_with_the_configs_blocks(monkeypatch):
    calls = []
    real = harness.run_attention_bench

    def counting(cfg, **kw):
        calls.append(cfg)
        return real(cfg, **kw)

    monkeypatch.setattr(harness, "run_attention_bench", counting)
    cfg = harness.AttentionBenchConfig(**SMALL)
    rep = harness.autotune_attention(cfg, variants=("loop", "kvgrid"))
    assert len(calls) == 1
    assert (rep.config.block_q, rep.config.block_k) == (256, 512)
    with pytest.raises(ValueError, match="variant"):
        harness.autotune_attention(cfg, variants=("loop", "zigzag"))
    with pytest.raises(ValueError, match="positive"):
        harness.autotune_attention(cfg, blocks=((256, 0),))
    assert len(calls) == 1


@pytest.mark.parametrize("field,value", (("impl", "cudnn"), ("mode", "bwd"),
                                         ("timing", "wall"),
                                         ("variant", "zigzag")))
def test_unknown_arguments_raise_as_in_jax(field, value):
    cfg = harness.AttentionBenchConfig(**SMALL, **{field: value})
    with pytest.raises(ValueError, match=value):
        harness.run_attention_bench(cfg)


def test_cli_prints_the_jax_line_and_the_payload(capsys):
    assert bench_main(["--bench", "attention", *CLI_SMALL,
                       "--attn-mode", "grad", "--autotune"]) == 0
    line, payload = capsys.readouterr().out.strip().splitlines()[-2:]
    assert line.startswith("flash(bq=256, bk=512): ") and "ms/call" in line
    doc = json.loads(payload)
    assert (doc["impl"], doc["mode"], doc["device"]) == ("flash", "grad", "cpu")
    assert bench_main(["--bench", "attention", *CLI_SMALL, "--attn-impl",
                       "stock", "--attn-timing", "chained"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["impl"] == "stock" and doc["variant"] is None


def test_cli_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_main(["--bench", "attention", "--batch", "1", "--seq-len", "32"])
