"""The port's ranking model held against the JAX package.

Both packages run the same numpy-seeded batch on the same weights (the flax
tree converted by ``recommend_tpu_torch.convert.params_from_flax``) at
float32 on the CPU: logits agree to atol 1e-5. With ``use_flash_attention``
on and sequences long enough that the kept query windows reach 64 rows, the
JAX side runs its Pallas kernels in interpret mode and the port takes the
kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _tiny_cfg
from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.data.synthetic import make_ranking_data
from recommend_tpu.models import ranking as jranking
from recommend_tpu.models.ranking import RankingModel as JaxRankingModel
from recommend_tpu.ops.normalization import RMSNorm as JaxRMSNorm
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import init_params, params_from_flax
from recommend_tpu_torch.models import ranking as tranking
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.ops.normalization import RMSNorm
from tests.jax_bf16_shim import bf16_as_on_the_card

torch.set_num_threads(1)

ATOL = 1e-5


def port_config(jax_cfg) -> RankingConfig:
    return RankingConfig.from_dict(jax_cfg.to_dict())


def make_batch(cfg, seq_len: int, batch_size: int = 2, seed: int = 0):
    data = make_ranking_data(cfg, num_samples=max(8, batch_size),
                             max_seq_per_feature=seq_len, seed=seed)
    return next(iter(ranking_batches(data, cfg, batch_size=batch_size,
                                     num_epochs=1)))


def jax_args(batch):
    return tuple({k: jnp.asarray(v) for k, v in batch[n].items()}
                 for n in ("non_seq", "sequences", "seq_valid"))


def torch_args(batch):
    conv = lambda v: torch.from_numpy(np.asarray(v)).to(
        torch.bool if v.dtype == bool else torch.long)
    return tuple({k: conv(v) for k, v in batch[n].items()}
                 for n in ("non_seq", "sequences", "seq_valid"))


def jax_params(cfg, batch, seed: int = 0):
    return JaxRankingModel(cfg).init(jax.random.key(seed), *jax_args(batch))


def port_model(cfg, params) -> RankingModel:
    tcfg = port_config(cfg)
    model = RankingModel(tcfg)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return model.eval()


def assert_logits_close(t_out, j_out, atol=ATOL):
    assert list(t_out) == list(j_out)
    for task in j_out:
        np.testing.assert_allclose(t_out[task].detach().numpy(),
                                   np.asarray(j_out[task]), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    batch = make_batch(cfg, seq_len=8)
    params = jax_params(cfg, batch)
    return cfg, batch, params, port_model(cfg, params)


def test_config_presets_match():
    from recommend_tpu import config as jconfig
    from recommend_tpu_torch import config as tconfig

    for name in ("ranking_base", "ranking_small", "ranking_large"):
        assert (tconfig.get_config(name, num_heads=2).to_dict()
                == jconfig.get_config(name, num_heads=2).to_dict())
    cfg = _tiny_cfg()
    assert RankingConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("total", [8, 30, 150, 1214])
def test_pyramid_keep_lengths_match(total):
    cfg = _tiny_cfg()
    for ratios in ((0.5, 0.25), (1.0, 0.01)):
        c = dataclasses.replace(cfg, pyramid_ratios=ratios)
        assert (tranking.pyramid_keep_lengths(port_config(c), total)
                == jranking.pyramid_keep_lengths(c, total))


def test_rmsnorm_matches():
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    scale = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    j = JaxRMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = RMSNorm(16)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j), atol=ATOL, rtol=1e-6)


def test_tokenizer_matches(tiny):
    cfg, batch, params, model = tiny
    jm = JaxRankingModel(cfg)
    ns, seqs, sv = jax_args(batch)
    tns, tseqs, tsv = torch_args(batch)
    tok = model.tokenizer
    with torch.no_grad():
        j_ns = jm.apply(params, ns, method=lambda m, a: m.tokenizer.ns_tokens(a))
        np.testing.assert_allclose(tok.ns_tokens(tns).numpy(), np.asarray(j_ns), atol=ATOL)
        j_s, j_v = jm.apply(params, seqs, sv,
                            method=lambda m, a, b: m.tokenizer.s_tokens(a, b))
        t_s, t_v = tok.s_tokens(tseqs, tsv)
        # [SEP] between the three sequences, not after the last one
        assert t_s.shape[1] == 3 * 8 + 2
        np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=ATOL)
        assert np.array_equal(t_v.numpy(), np.asarray(j_v))
        # the NS-only stream: no sequences, S length 0
        j_x, j_xv = jm.apply(params, ns, {}, {},
                             method=lambda m, a, b, c: m.tokenizer(a, b, c))
        t_x, t_xv = tok(tns, {}, {})
        assert t_x.shape == (2, cfg.num_ns_tokens, cfg.embed_dim)
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=ATOL)
        assert np.array_equal(t_xv.numpy(), np.asarray(j_xv))


def test_forward_and_kv_cache_match_jax(tiny):
    cfg, batch, params, model = tiny
    jm = JaxRankingModel(cfg)
    ns, seqs, sv = jax_args(batch)
    j_full = jm.apply(params, ns, seqs, sv)
    j_cache = jm.apply(params, seqs, sv, method=JaxRankingModel.encode_s)
    j_cached = jm.apply(params, j_cache, ns, method=JaxRankingModel.score_with_cache)
    with torch.no_grad():
        tns, tseqs, tsv = torch_args(batch)
        t_full = model(tns, tseqs, tsv)
        t_cache = model.encode_s(tseqs, tsv)
        t_cached = model.score_with_cache(t_cache, tns)
    assert_logits_close(t_full, j_full)
    assert_logits_close(t_cached, j_cached)
    for t_entry, j_entry in zip(t_cache, j_cache):
        assert (t_entry is None) == (j_entry is None)
        if t_entry is not None:
            for t_arr, j_arr in zip(t_entry, j_entry):
                np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr), atol=ATOL)


def test_kv_cache_invariant_holds_in_the_port(tiny):
    """score_with_cache(encode_s(x)) reproduces the full forward, the
    candidate batch broadcasting over a batch-1 cache."""
    cfg, batch, _, model = tiny
    tns, tseqs, tsv = torch_args(batch)
    with torch.no_grad():
        full = model(tns, tseqs, tsv)
        for row in range(2):
            cache = model.encode_s({k: v[row:row + 1] for k, v in tseqs.items()},
                                   {k: v[row:row + 1] for k, v in tsv.items()})
            cands = {k: v[row:row + 1].expand(3) for k, v in tns.items()}
            cached = model.score_with_cache(cache, cands)
            for task in full:
                np.testing.assert_allclose(
                    cached[task].numpy(), np.full(3, full[task][row].item()),
                    atol=1e-6, rtol=0)


FLASH_CASES = [
    # (embed_dim, num_heads): Dh 32 -> [B·H, L, Dh] kernel;
    # Dh 128 -> the model-layout and segmented kernels
    (64, 2),
    (128, 1),
]


@pytest.mark.parametrize("embed_dim,num_heads", FLASH_CASES)
def test_flash_path_matches_jax(embed_dim, num_heads):
    """48 items per sequence: S = 146, so layer 0 keeps 75 rows (71 S rows in
    encode_s), past the 64-row kernel threshold on both paths."""
    cfg = dataclasses.replace(_tiny_cfg(), embed_dim=embed_dim,
                              num_heads=num_heads, use_flash_attention=True)
    batch = make_batch(cfg, seq_len=48)
    # the same parameters; initializing through the kernels would need them
    # compiled for a TPU
    params = jax_params(dataclasses.replace(cfg, use_flash_attention=False), batch)
    model = port_model(cfg, params)
    jm = JaxRankingModel(cfg)
    ns, seqs, sv = jax_args(batch)
    with pltpu.force_tpu_interpret_mode():
        j_full = jm.apply(params, ns, seqs, sv)
        j_cache = jm.apply(params, seqs, sv, method=JaxRankingModel.encode_s)
    j_cached = jm.apply(params, j_cache, ns, method=JaxRankingModel.score_with_cache)
    with torch.no_grad():
        tns, tseqs, tsv = torch_args(batch)
        assert_logits_close(model(tns, tseqs, tsv), j_full)
        assert_logits_close(model.score_with_cache(model.encode_s(tseqs, tsv), tns),
                            j_cached)


def test_mixed_precision_forward_tracks_float32(tiny):
    """bf16 compute: tokens and the trunk run in bf16, the heads in float32.
    The logits stay within bf16's reach of the float32 ones on the same
    weights, and follow JAX's bf16 forward, which runs on the CPU through
    ``tests/jax_bf16_shim.py`` (bf16 products and sums accumulated in f32,
    as on the card; measured 5.5e-3 at most, held at 2e-2)."""
    cfg, batch, params, model32 = tiny
    cfg16 = dataclasses.replace(cfg, use_mixed_precision=True)
    model = port_model(cfg16, params)
    args = torch_args(batch)
    with torch.no_grad():
        tokens, _ = model.tokenizer(*args)
        t16, t32 = model(*args), model32(*args)
        cache = model.encode_s(args[1], args[2])
        cached = model.score_with_cache(cache, args[0])
    assert tokens.dtype == torch.bfloat16
    assert all(entry[0].dtype == torch.bfloat16 for entry in cache)
    assert all(v.dtype == torch.float32 for v in t16.values())
    assert_logits_close(t16, {k: v.numpy() for k, v in t32.items()}, atol=3e-2)
    assert_logits_close(cached, {k: v.numpy() for k, v in t16.items()}, atol=3e-2)
    jm = JaxRankingModel(cfg16)
    ns, seqs, sv = jax_args(batch)
    with bf16_as_on_the_card():
        j16 = jm.apply(params, ns, seqs, sv)
        j_cached = jm.apply(params, jm.apply(params, seqs, sv, method=JaxRankingModel.encode_s),
                            ns, method=JaxRankingModel.score_with_cache)
    assert_logits_close(t16, j16, atol=2e-2)
    assert_logits_close(cached, j_cached, atol=2e-2)


def test_init_params_is_seeded_and_complete():
    cfg = port_config(_tiny_cfg())
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    ref = RankingModel(cfg).state_dict()
    assert set(a) == set(ref)
    assert all(a[k].shape == ref[k].shape for k in ref)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.q_ns"], c["blocks.0.q_ns"])
    assert torch.all(a["final_norm.scale"] == 1) and torch.all(a["blocks.1.k_s.bias"] == 0)
    table = a["tokenizer.embeds.user_id.weight"]
    assert abs(table.std().item() - 0.02) < 2e-3
    model = RankingModel(cfg)
    model.load_state_dict(a)
    with torch.no_grad():
        out = model(*torch_args(make_batch(_tiny_cfg(), seq_len=8)))
    assert all(torch.isfinite(v).all() for v in out.values())


def _s_trunk_loss(cache, noise, mul, add):
    """L = sum over layers of <k_s, R_k> + <v_s, R_v>, each R masked by the
    layer's key validity (a fully padded query row then gets dO = 0, where
    the kernel backwards recompute p = 1 and the plain path 1/n)."""
    total = 0.0
    for (k, v, valid), (rk, rv) in zip(cache, noise):
        m = valid[..., None, None]
        total = add(total, mul(k, rk * m) + mul(v, rv * m))
    return total


def test_s_trunk_gradient_matches_jax(monkeypatch):
    """The gradient of a scalar of encode_s's cache with respect to every
    dense parameter: jax.grad through the JAX model (Pallas kernels in
    interpret mode) against torch autograd through the port's (plain
    versions, band_attn_mh_bwd_plain in layer 0, which keeps 71 S rows at
    Dh 128). float32, rtol 1e-4, and atol 1e-5 of the parameter's largest
    gradient entry: entries reach ~6e3 here, and an entry that is a sum
    cancelling to below 1 moves by ~1e-4 with the order of float32 sums
    alone (the two frameworks sum in other orders; measured, every
    difference is below 7e-7 of its parameter's largest entry)."""
    from recommend_tpu_torch.convert import table_param_names
    from recommend_tpu_torch.ops import flash_attention as tfa

    cfg = dataclasses.replace(_tiny_cfg(), embed_dim=128, num_heads=1,
                              use_flash_attention=True)
    batch = make_batch(cfg, seq_len=48)
    params = jax_params(dataclasses.replace(cfg, use_flash_attention=False), batch)
    model = port_model(cfg, params)
    _, tseqs, tsv = torch_args(batch)
    _, seqs, sv = jax_args(batch)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        shapes = [tuple(k.shape) for k, _, _ in model.encode_s(tseqs, tsv)]
    noise = [tuple(rng.normal(size=s).astype(np.float32) for _ in range(2))
             for s in shapes]

    calls = []
    plain = tfa.band_attn_mh_bwd_plain
    monkeypatch.setattr(tfa, "band_attn_mh_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    dense = [(n, p) for n, p in model.named_parameters()
             if n not in table_param_names(port_config(cfg))]
    loss = _s_trunk_loss(model.encode_s(tseqs, tsv),
                         [tuple(map(torch.from_numpy, r)) for r in noise],
                         lambda a, b: (a * b).sum(), lambda a, b: a + b)
    t_grads = torch.autograd.grad(loss, [p for _, p in dense], allow_unused=True)
    assert calls == [1]  # layer 0's backward, through the model-layout route

    jm = JaxRankingModel(cfg)
    j_noise = [tuple(map(jnp.asarray, r)) for r in noise]

    def j_loss(p):
        cache = jm.apply(p, seqs, sv, method=JaxRankingModel.encode_s)
        return _s_trunk_loss(cache, j_noise, lambda a, b: jnp.sum(a * b),
                             lambda a, b: a + b)

    with pltpu.force_tpu_interpret_mode():
        j_grads = jax.grad(j_loss)(params)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads), port_config(cfg))
    for (name, _), g in zip(dense, t_grads):
        want = ref[name].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    assert any(g is not None and g.abs().max() > 0 for g in t_grads)
