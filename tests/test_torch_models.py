"""The port's LM serving stack (repro_torch.configs / models / train.serve_step)
against the JAX package's (repro.configs / models / train.serve_step), on
the CPU at the reduced same-family configs.

Weights are drawn from a numpy seed into the structure of the reference's
``Model.init`` (at its scales, with nonzero biases and norm scales off 1),
flattened with the reference checkpointer's keys and carried across by
``models.convert.params_from_reference``; token ids and stub embeddings
come from numpy seeds too.  For all ten archs: ``apply`` logits and the MoE aux
loss, ``prefill`` and two ``decode_step``s (float32 caches) within
rtol 1e-4, atol 2e-5 of the reference's (float32: the two packages sum the
same products in other orders; the largest difference seen is 1.2e-6 on
logits of magnitude ~0.6), greedy tokens equal; the bfloat16 serve steps
within atol 0.05 of the reference's (bfloat16 rounds each op's output to
8 bits, 4e-3 relative, and the roundings differ between the two
libraries' fusions: the prefill logits differ by 4.4e-3 to 1.8e-2, jamba
the most; a MoE router whose top k sits on a near-tie could pick another
expert under either library's rounding, and none does here).  Then the counterparts of tests/test_models.py:75-205
on the port alone, the sliding-window cache write of a prompt longer than
the window, tied router probabilities, the weight mapping both ways and
both RMSNorm branches.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten as jflatten
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import reduced as jreduced
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.train import serve_step as jserve_step
from repro_torch import configs
from repro_torch.configs.base import SHAPES, LayerSpec, reduced, runnable
from repro_torch.models import layers, moe
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.model import Model, cast_floats
from repro_torch.train import serve_step

RTOL, ATOL = 1e-4, 2e-5
ATOL_BF16 = 0.05
B, S = 2, 8


def _draw(rng, key, shape):
    """A float32 leaf from numpy: the reference's init scales for the
    matrices (fan-in ** -0.5) and embeddings (0.02), and, where its init
    puts constants, values that exercise them (norm scales and D about 1,
    nonzero biases and dt_bias, A_log of decays in [1, 16])."""
    name = key.rsplit("/", 1)[-1]
    z = rng.normal(size=shape)
    if name == "embedding":
        w = z * 0.02
    elif name in ("scale", "norm", "D"):
        w = 1.0 + 0.1 * z
    elif name in ("bq", "bk", "bv", "dt_bias"):
        w = 0.1 * z
    elif name == "A_log":
        w = np.log(rng.uniform(1.0, 16.0, size=shape))
    elif name.startswith("conv_"):
        w = 0.1 * z
    elif name == "wo":
        w = z * (shape[1] * shape[2]) ** -0.5
    elif len(shape) == 4 and "/ffn/" in key:        # experts (R, E, in, out)
        w = z * shape[2] ** -0.5
    else:                                           # (R, in, ...)
        w = z * shape[1] ** -0.5
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(arch, **overrides):
    """The reference's reduced config, its param tree (the structure of its
    ``Model.init``, the leaves drawn by ``_draw`` from a numpy seed) and
    that tree flattened with its checkpointer's keys."""
    jcfg = jreduced(jconfigs.get(arch), **overrides)
    shapes = jax.eval_shape(
        lambda: JModel(jcfg).init(jax.random.PRNGKey(0))[0])
    keys = list(jflatten(shapes))
    rng = np.random.default_rng(sum(map(ord, arch)))
    flat = {k: _draw(rng, k, jflatten(shapes)[k].shape) for k in keys}
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                      [jnp.asarray(flat[k]) for k in keys])
    return jcfg, jp, flat


def _pair(arch, **overrides):
    jcfg, jp, flat = _reference(arch, **overrides)
    cfg = reduced(configs.get(arch), **overrides)
    return jcfg, jp, cfg, params_from_reference(flat, cfg)


def _inputs(cfg, seed, b=B, s=S):
    """(reference batch, port batch): token ids, or stub embeddings for
    the audio and vlm archs."""
    rng = np.random.default_rng(seed)
    if cfg.modality in ("audio", "vlm"):
        e = (rng.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.as_tensor(e)}
    t = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.as_tensor(t).long()}


def _np(x, cfg):
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x[..., :cfg.vocab_size].astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _same_keys(cfg, jcfg):
    """The port's config as a dict, and the reference's restricted to the
    port's keys (the reference's mesh, lowering and training knobs have
    no field in the port)."""
    mine, ref = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert set(mine) <= set(ref)
    return mine, {k: ref[k] for k in mine}


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    for arch in configs.ARCHS:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        mine, ref = _same_keys(cfg, jcfg)
        assert mine == ref, arch
        mine, ref = _same_keys(reduced(cfg), jreduced(jcfg))
        assert mine == ref, arch
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.param_count() == jcfg.param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-17")


def test_param_counts_match_sizes():
    expect = {
        "phi3.5-moe-42b-a6.6b": (41.9e9, 6.6e9),
        "granite-moe-1b-a400m": (1.3e9, 0.4e9),
        "mamba2-780m": (0.78e9, 0.78e9),
        "qwen2.5-14b": (14.8e9, 14.8e9),
        "llama3.2-3b": (3.2e9, 3.2e9),
        "gemma2-2b": (2.6e9, 2.6e9),
        "gemma2-9b": (9.2e9, 9.2e9),
        "jamba-1.5-large-398b": (398e9, 94e9),
        "musicgen-medium": (1.8e9, 1.8e9),
        "internvl2-1b": (0.49e9, 0.49e9),
    }
    for arch, (t0, a0) in expect.items():
        t, a = configs.get(arch).param_count()
        assert abs(t - t0) / t0 < 0.06, (arch, t, t0)
        assert abs(a - a0) / a0 < 0.11, (arch, a, a0)


def test_runnable_matrix():
    cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    assert len(cells) == 40
    skipped = [(a, s) for a, s in cells
               if not runnable(configs.get(a), SHAPES[s])[0]]
    assert len(skipped) == 6
    assert all(s == "long_500k" for _, s in skipped)
    assert {a for a, _ in skipped} == {
        "phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "qwen2.5-14b",
        "llama3.2-3b", "musicgen-medium", "internvl2-1b",
    }
    for a, s in cells:
        assert (runnable(configs.get(a), SHAPES[s])
                == jconfigs.runnable(jconfigs.get(a), jconfigs.SHAPES[s]))


# ---------------------------------------------------------------------------
# the weight mapping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_weights_map_both_ways(arch):
    """Every reference leaf lands once, with its shape, and comes back
    bitwise; the port's state_dict names are the reference's keys."""
    _, _, flat = _reference(arch)
    params = params_from_reference(flat, reduced(configs.get(arch)))
    assert {k.replace(".", "/") for k in params.state_dict()} == set(flat)
    back = params_to_reference(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_weight_mapping_is_checked():
    _, _, flat = _reference("llama3.2-3b")
    cfg = reduced(configs.get("llama3.2-3b"))
    missing = {k: v for k, v in flat.items() if k != "final_norm/scale"}
    with pytest.raises(ValueError, match="missing.*final_norm/scale"):
        params_from_reference(missing, cfg)
    with pytest.raises(ValueError, match="unexpected.*lm_head/embedding"):
        params_from_reference({**flat, "lm_head/embedding": flat[
            "embed/embedding"]}, cfg)
    bad = dict(flat, **{"blocks/0/mixer/wq": flat["blocks/0/mixer/wq"][:1]})
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_reference(bad, cfg)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_init_draws_the_references_distributions(arch):
    """The port's own init: the reference's shapes, scales and constants
    from an explicit generator (the same seed gives the same weights)."""
    cfg = reduced(configs.get(arch))
    a = Model(cfg).init(3, "cpu").state_dict()
    b = Model(cfg).init(3, "cpu").state_dict()
    jcfg = jreduced(jconfigs.get(arch))
    ref = {k: np.asarray(v) for k, v in jflatten(jax.jit(
        lambda key: JModel(jcfg).init(key)[0])(jax.random.PRNGKey(0))).items()}
    for k, v in a.items():
        r = ref[k.replace(".", "/")]
        assert tuple(v.shape) == r.shape and v.dtype == torch.float32, k
        assert torch.equal(v, b[k]), k
        if k.endswith(("A_log", "D", "dt_bias", "scale", "norm")):
            np.testing.assert_allclose(v.numpy(), r, rtol=1e-6)
        elif v.numel() >= 1024:   # enough draws to compare the scale
            assert abs(float(v.std()) / float(r.std()) - 1) < 0.1, k


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_apply_matches_reference(arch):
    jcfg, jp, cfg, params = _pair(arch)
    jb, tb = _inputs(cfg, 1, s=16)
    jl, jaux = jax.jit(JModel(jcfg).apply)(jp, jb)
    with torch.no_grad():
        tl, taux = Model(cfg).apply(params, tb)
    assert tl.shape == (B, 16, cfg.padded_vocab)
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=1e-7)
    if cfg.padded_vocab != cfg.vocab_size:
        assert bool((tl[..., cfg.vocab_size:] == layers.NEG_INF).all())


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill, then two decode steps on the greedy tokens, float32
    caches: logits within RTOL / ATOL, the tokens equal."""
    jcfg, jp, cfg, params = _pair(arch)
    jm, m = JModel(jcfg), Model(cfg)
    jpre, jdec = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jb, tb = _inputs(cfg, 2)
    jc = jm.init_caches(B, S + 2, dtype=jnp.float32)
    tc = m.init_caches(B, S + 2, dtype=torch.float32, device="cpu")
    jl, jc = jpre(jp, jb, jc)
    tl, tc = m.prefill(params, tb, tc)
    for i in range(3):
        np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        jt = jnp.argmax(jl[..., :cfg.vocab_size], -1)[:, None]
        tt = torch.argmax(tl[..., :cfg.vocab_size], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if i == 2:
            break
        jl, jc = jdec(jp, jt.astype(jnp.int32), jc,
                      jnp.asarray(S + i, jnp.int32))
        tl, tc = m.decode_step(params, tt, tc, S + i)
    assert [int(c["pos"][0]) for c in tc if "pos" in c] == [
        S + 2 for c in tc if "pos" in c]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_bf16_serve_steps_match_reference(arch):
    """make_prefill_step / make_decode_step (bfloat16 params and caches,
    float32 logits) against the reference's, on float32 weights."""
    jcfg, jp, cfg, params = _pair(arch)
    jb, tb = _inputs(cfg, 3)
    jpre = jax.jit(jserve_step.make_prefill_step(jcfg))
    jdec = jax.jit(jserve_step.make_decode_step(jcfg))
    pre = serve_step.make_prefill_step(cfg)
    dec = serve_step.make_decode_step(cfg)
    jc = JModel(jcfg).init_caches(B, S + 1)
    tc = Model(cfg).init_caches(B, S + 1, device="cpu")
    jl, jc = jpre(jp, jb, jc)
    tl, tc = pre(params, tb, tc)
    assert tl.dtype == torch.float32
    assert tc[0][next(iter(tc[0]))].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=0,
                               atol=ATOL_BF16)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 1))
    jl, _ = jdec(jp, jnp.asarray(tok, jnp.int32), jc,
                 jnp.asarray(S, jnp.int32))
    tl, _ = dec(params, torch.as_tensor(tok), tc, S)
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=0,
                               atol=ATOL_BF16)
    assert np.isfinite(_np(tl, cfg)).all()


def test_serve_steps_cast_the_params_once():
    """The caller casts once (``cast_floats``); a step's own cast of
    parameters already in bfloat16 hands them back as they are, so the
    steps hold no second copy of the weights."""
    cfg = reduced(configs.get("llama3.2-3b"))
    m = Model(cfg)
    params = m.init(0, "cpu")
    bf = cast_floats(params, torch.bfloat16)
    assert params.embed.embedding.dtype == torch.float32
    assert bf.embed.embedding.dtype == torch.bfloat16
    assert cast_floats(bf, torch.bfloat16) is bf
    pre = serve_step.make_prefill_step(cfg)
    dec = serve_step.make_decode_step(cfg)
    caches = m.init_caches(B, S + 3, device="cpu")
    _, tb = _inputs(cfg, 5)
    l_bf, caches_bf = pre(bf, tb, caches)
    l_f32, _ = pre(params, tb, m.init_caches(B, S + 3, device="cpu"))
    torch.testing.assert_close(l_bf, l_f32, rtol=0, atol=0)
    for i in range(3):
        logits, caches_bf = dec(bf, tb["tokens"][:, :1], caches_bf, S + i)
        assert logits.dtype == torch.float32


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b"])
def test_q_chunk_loop_matches_reference(arch):
    """A prompt of several query chunks (S > q_chunk, S % q_chunk == 0)."""
    jcfg, jp, cfg, params = _pair(arch)
    jb, tb = _inputs(cfg, 6, s=12)
    jl, _ = jax.jit(functools.partial(JModel(jcfg).apply, q_chunk=4))(jp, jb)
    with torch.no_grad():
        tl, _ = Model(cfg).apply(params, tb, q_chunk=4)
        whole, _ = Model(cfg).apply(params, tb)
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_window_shorter_than_prompt_matches_reference():
    """A prefill longer than a sliding window writes only the last Sc
    tokens into the circular cache (the reference's
    ``layers.py:220-227``); decode then wraps around it."""
    W = 4
    pat = (LayerSpec(mixer="attn", ffn="dense", window=W),
           LayerSpec(mixer="attn", ffn="dense", window=None))
    jpat = tuple(JLayerSpec(**dataclasses.asdict(p)) for p in pat)
    jcfg, jp, flat = _reference("gemma2-2b", pattern=jpat)
    cfg = reduced(configs.get("gemma2-2b"), pattern=pat)
    params = params_from_reference(flat, cfg)
    jm, m = JModel(jcfg), Model(cfg)
    jpre, jdec = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jb, tb = _inputs(cfg, 7, s=10)
    jc = jm.init_caches(B, 13, dtype=jnp.float32)
    tc = m.init_caches(B, 13, dtype=torch.float32, device="cpu")
    assert tc[0]["k"].shape[2] == W and tc[1]["k"].shape[2] == 13
    jl, jc = jpre(jp, jb, jc)
    tl, tc = m.prefill(params, tb, tc)
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                               atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0][name].numpy(),
                                   np.asarray(jc[0][name]), rtol=RTOL,
                                   atol=ATOL)
    for i in range(3):
        tok = np.random.default_rng(8 + i).integers(0, cfg.vocab_size, (B, 1))
        jl, jc = jdec(jp, jnp.asarray(tok, jnp.int32), jc,
                      jnp.asarray(10 + i, jnp.int32))
        tl, tc = m.decode_step(params, torch.as_tensor(tok), tc, 10 + i)
        np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# counterparts of tests/test_models.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-2b", "mamba2-780m",
                                  "jamba-1.5-large-398b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full-sequence forward logits
    (KV-cache / SSM-state correctness)."""
    cfg = reduced(configs.get(arch))
    m = Model(cfg)
    params = m.init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, 12)))
    with torch.no_grad():
        full, _ = m.apply(params, {"tokens": toks})
    caches = m.init_caches(B, 12, dtype=torch.float32, device="cpu")
    steps = []
    for i in range(12):
        lg, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-3)


def test_prefill_then_decode_matches_forward():
    cfg = reduced(configs.get("llama3.2-3b"))
    m = Model(cfg)
    params = m.init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, 10)))
    with torch.no_grad():
        full, _ = m.apply(params, {"tokens": toks})
    caches = m.init_caches(B, 10, dtype=torch.float32, device="cpu")
    last, caches = m.prefill(params, {"tokens": toks[:, :-1]}, caches)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(), rtol=2e-2,
                               atol=2e-3)
    lg, _ = m.decode_step(params, toks[:, -1:], caches, 9)
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), rtol=2e-2,
                               atol=2e-3)


def test_sliding_window_masks_old_tokens():
    """A stack of window-4 layers: a token further back than the stack
    can reach changes nothing at the last position, a near one does."""
    base = reduced(configs.get("gemma2-2b"))
    cfg = dataclasses.replace(
        base, n_layers=2,
        pattern=(LayerSpec(mixer="attn", ffn="dense", window=4),))
    m = Model(cfg)
    params = m.init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, 16)))
    toks2 = toks.clone()
    toks2[:, 0] = (toks[:, 0] + 7) % cfg.vocab_size
    with torch.no_grad():
        lg1, _ = m.apply(params, {"tokens": toks})
        lg2, _ = m.apply(params, {"tokens": toks2})
    V = cfg.vocab_size
    np.testing.assert_allclose(lg1[:, -1, :V].numpy(), lg2[:, -1, :V].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(lg1[:, 1, :V].numpy(), lg2[:, 1, :V].numpy())


def test_moe_load_balance_aux_positive():
    cfg = reduced(configs.get("phi3.5-moe-42b-a6.6b"))
    m = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        _, aux = m.apply(m.init(0, "cpu"), {"tokens": toks})
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "granite-moe-1b-a400m"])
def test_moe_tied_router_probabilities_match_reference(arch):
    """A zero router gives every expert the same probability: both
    packages route each token to experts 0..k-1 (ties to the lower
    index), and the outputs agree."""
    jcfg, jp, cfg, params = _pair(arch)
    jp = jax.tree_util.tree_map(lambda x: x, jp)
    jp["blocks"][0]["ffn"]["router"] = jnp.zeros_like(
        jp["blocks"][0]["ffn"]["router"])
    with torch.no_grad():
        params.blocks[0].ffn.router.zero_()
    probs = torch.full((1, 5, cfg.moe.n_experts), 1.0 / cfg.moe.n_experts)
    _, ids = moe.top_k(probs, cfg.moe.top_k)
    assert ids.tolist() == [[list(range(cfg.moe.top_k))] * 5]
    _, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jb, tb = _inputs(cfg, 13)
    jl, jaux = jax.jit(JModel(jcfg).apply)(jp, jb)
    with torch.no_grad():
        tl, taux = Model(cfg).apply(params, tb)
    np.testing.assert_allclose(_np(tl, cfg), _np(jl, cfg), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(f32, dtype):
    rng = np.random.default_rng(14)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6, f32=f32)
    got = layers.rmsnorm(torch.as_tensor(scale), tx, 1e-6, f32=f32)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
