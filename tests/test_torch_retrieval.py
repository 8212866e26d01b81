"""The port's retrieval tower and its inputs held against the JAX package on
the CPU.

The same seeded numpy inputs and the converted weights
(``convert.retrieval_params_from_flax``) go through both packages:

- ``RetrievalConfig``, ``CompressionGroupSpec`` and the three presets, field
  for field, and ``load_config`` of a JAX-written retrieval file;
- ``make_retrieval_data`` (plain and ``structured``), ``retrieval_batches``
  and ``NegativeSampler``, array for array (exact);
- the bucketizers (exact), ``FeatureEmbedding``, ``MultiHeadAttention``,
  ``TransformerBlock``, ``AdaptiveCompression`` and every ``RetrievalTower``
  mode at float32 within ``F32_TOL`` of the largest reference value;
- the tower in bf16 within ``BF16_TOL`` of the largest reference value (each
  eager op rounds to bf16 on both sides, in different places);
- ``init_retrieval_params``: the tower's names, shapes and initializer rules.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu import config as jconfig
from recommend_tpu.data.pipeline import _pad_history as j_pad_history
from recommend_tpu.data.pipeline import build_retrieval_examples as j_examples
from recommend_tpu.data.pipeline import retrieval_batches as j_batches
from recommend_tpu.data.sampler import NegativeSampler as JSampler
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu.models.retrieval import RetrievalTower as JTower
from recommend_tpu.ops import embedding as jemb
from recommend_tpu.ops.attention import MultiHeadAttention as JMHA
from recommend_tpu.ops.compression import AdaptiveCompression as JCompression
from recommend_tpu.ops.embedding import FeatureEmbedding as JEmbedding
from recommend_tpu.ops.transformer import TransformerBlock as JBlock
from recommend_tpu_torch import config as tconfig
from recommend_tpu_torch.convert import init_retrieval_params, retrieval_params_from_flax
from recommend_tpu_torch.data.pipeline import _pad_history, build_retrieval_examples, retrieval_batches
from recommend_tpu_torch.data.sampler import NegativeSampler
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.models.retrieval import RetrievalTower, load_tower
from recommend_tpu_torch.ops import embedding as temb

torch.set_num_threads(1)

F32_TOL = 1e-5  # of max|ref|: float32 on both sides, sums in other orders
BF16_TOL = 3e-2  # of max|ref|: a few bf16 ulps (2^-8 = 3.9e-3 each); 1.6e-2 measured
PRESETS = ("retrieval_base", "retrieval_flagship", "retrieval_small")


def tiny_cfg(**overrides):
    """``tests/test_serving.py``'s retrieval config: embed 32, 1 layer,
    ``max_seq_len`` 16 (groups of 4, then 8 raw)."""
    kw = dict(embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, max_seq_len=16,
              compression_schedule=((8, 4), (8, 1)), video_vocab_size=500, batch_size=8,
              dropout_rate=0.0, compute_dtype="float32", top_k=20)
    kw.update(overrides)
    return jconfig.get_config("retrieval_small", **kw)


def port_cfg(cfg):
    return tconfig.RetrievalConfig.from_dict(cfg.to_dict())


def first_batch(cfg, bs=4):
    data = j_data(cfg, num_users=10, num_videos=200, seed=0)
    return next(iter(j_batches(data, cfg, batch_size=bs, num_epochs=1, use_native=False)))


def jax_in(batch):
    return ({k: jnp.asarray(v) for k, v in batch["history"].items()},
            jnp.asarray(batch["history_valid"]))


def torch_in(batch):
    return ({k: torch.as_tensor(v) for k, v in batch["history"].items()},
            torch.as_tensor(batch["history_valid"]))


def jax_tower(cfg, batch):
    """(flax tower, its params, the port tower on the converted params)."""
    model = JTower(cfg)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), *jax_in(batch)))
    tcfg = port_cfg(cfg)
    return model, params, load_tower(tcfg, retrieval_params_from_flax(params, tcfg),
                                     torch.device("cpu"))


def close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def f32_setup():
    cfg = tiny_cfg()
    batch = first_batch(cfg)
    return (cfg, batch) + jax_tower(cfg, batch)


# -- config ------------------------------------------------------------------


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_retrieval_config_classes_match_field_for_field():
    assert _fields(tconfig.RetrievalConfig) == _fields(jconfig.RetrievalConfig)
    assert _fields(tconfig.CompressionGroupSpec) == _fields(jconfig.CompressionGroupSpec)
    cfg = tiny_cfg(use_causal_mask=True)
    assert tconfig.RetrievalConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    with pytest.raises(AssertionError, match="cover max_seq_len"):
        tconfig.RetrievalConfig(max_seq_len=100)


@pytest.mark.parametrize("name", PRESETS)
def test_retrieval_presets_match(name):
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    assert t.to_dict() == j.to_dict()
    assert t.num_compressed_tokens == j.num_compressed_tokens
    assert [(s.length, s.group_size, s.num_tokens) for s in t.schedule_specs()] == [
        (s.length, s.group_size, s.num_tokens) for s in j.schedule_specs()]


def test_load_config_reads_a_jax_retrieval_file(tmp_path):
    cfg = jconfig.get_config("retrieval_flagship", top_k=100, dropout_rate=0.0)
    jconfig.save_config(cfg, str(tmp_path / "r.json"))
    got = tconfig.load_config(str(tmp_path / "r.json"))
    assert isinstance(got, tconfig.RetrievalConfig)
    assert got.to_dict() == cfg.to_dict()


# -- data --------------------------------------------------------------------


def _same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("structured", [False, True], ids=["iid", "structured"])
def test_make_retrieval_data_matches(structured):
    cfg = jconfig.get_config("retrieval_small")
    kw = dict(num_users=20, num_videos=300, seed=3, structured=structured)
    j, t = j_data(cfg, **kw), make_retrieval_data(port_cfg(cfg), **kw)
    _same_arrays(t.video_features, j.video_features)
    np.testing.assert_array_equal(t.popularity, j.popularity)
    np.testing.assert_array_equal(t.sampling_probs(), j.sampling_probs())
    _same_arrays(t.corpus_features(), j.corpus_features())
    assert len(t.user_sequences) == len(j.user_sequences)
    for a, b in zip(t.user_sequences, j.user_sequences):
        _same_arrays(a, b)


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native_flag"])
def test_retrieval_batches_match(use_native):
    cfg = jconfig.get_config("retrieval_small", max_seq_len=16,
                             compression_schedule=((8, 4), (8, 1)))
    j = j_data(cfg, num_users=12, num_videos=300, seed=1)
    t = make_retrieval_data(port_cfg(cfg), num_users=12, num_videos=300, seed=1)
    assert build_retrieval_examples(t, port_cfg(cfg), max_samples_per_user=7) == j_examples(
        j, cfg, max_samples_per_user=7)
    for end in (3, 16, 30):
        h, v = _pad_history(t.user_sequences[0], end, 16)
        jh, jv = j_pad_history(j.user_sequences[0], end, 16)
        _same_arrays(h, jh)
        np.testing.assert_array_equal(v, jv)
    jb = list(j_batches(j, cfg, batch_size=8, seed=2, num_epochs=2, use_native=False))
    tb = list(retrieval_batches(t, port_cfg(cfg), batch_size=8, seed=2, num_epochs=2,
                                use_native=use_native))
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        _same_arrays(a["history"], b["history"])
        _same_arrays(a["target"], b["target"])
        for k in ("history_valid", "target_popularity", "history_popularity"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("strategy", ["popularity", "uniform"])
def test_negative_sampler_matches(strategy):
    pop = np.random.default_rng(0).poisson(10.0, 50).astype(np.float32) + 1
    j, t = JSampler(pop, strategy, seed=4), NegativeSampler(pop, strategy, seed=4)
    np.testing.assert_array_equal(t.sample_negatives(10, positive=3),
                                  j.sample_negatives(10, positive=3))
    np.testing.assert_array_equal(t.sample_negatives_with_exclusion(20, [1, 2, 5]),
                                  j.sample_negatives_with_exclusion(20, [1, 2, 5]))
    np.testing.assert_array_equal(t.sample_negatives(5), j.sample_negatives(5))


# -- ops ---------------------------------------------------------------------


def test_bucketizers_match():
    rng = np.random.default_rng(0)
    dur = np.concatenate([rng.uniform(0.0, 400.0, 5000),
                          np.arange(0.0, 300.0, 0.3), [0.0, 300.0, 299.99]]).astype(np.float32)
    ts = np.concatenate([1_700_000_000 + rng.integers(0, 86_400 * 30, 2000),
                         [0, 999, 1000, 2_000_000_000]]).astype(np.int64)
    np.testing.assert_array_equal(
        temb.bucketize_duration(torch.as_tensor(dur), 300.0, 1000).numpy(),
        np.asarray(jemb.bucketize_duration(jnp.asarray(dur), 300.0, 1000)))
    np.testing.assert_array_equal(
        temb.bucketize_timestamp(torch.as_tensor(ts), 1000).numpy(),
        np.asarray(jemb.bucketize_timestamp(jnp.asarray(ts), 1000)))
    assert temb.SPARSE_TABLES == jemb.SPARSE_TABLES


def test_feature_embedding_matches(f32_setup):
    cfg, batch, _, params, tower = f32_setup
    jf, _ = jax_in(batch)
    tf, _ = torch_in(batch)
    ref = JEmbedding(cfg).apply({"params": params["params"]["embed"]}, jf)
    close(tower.embed(tf), ref, F32_TOL)


def test_attention_block_and_compression_match(f32_setup):
    cfg, batch, _, params, tower = f32_setup
    p = params["params"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, cfg.embed_dim)).astype(np.float32)
    kv = rng.normal(size=(3, 5, cfg.embed_dim)).astype(np.float32)
    valid = rng.random((3, 5)) < 0.7
    valid[:, 0] = True
    bias = np.where(valid[:, None, None, :], 0.0, -1e9).astype(np.float32)
    mha = JMHA(num_heads=cfg.num_heads, embed_dim=cfg.embed_dim)
    ref = mha.apply({"params": p["block_0"]["attn"]}, jnp.asarray(x), jnp.asarray(kv),
                    jnp.asarray(bias))
    close(tower.blocks[0].attn(torch.as_tensor(x), torch.as_tensor(kv), torch.as_tensor(bias)),
          ref, F32_TOL)
    blk = JBlock(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, ffn_dim=cfg.ffn_dim)
    causal = np.where(np.tril(np.ones((7, 7), bool)), 0.0, -1e9).astype(np.float32)
    ref = blk.apply({"params": p["block_0"]}, jnp.asarray(x), jnp.asarray(causal))
    close(tower.blocks[0](torch.as_tensor(x), torch.as_tensor(causal)), ref, F32_TOL)
    # compression: one fully padded group and one partly padded history
    h = rng.normal(size=(2, cfg.max_seq_len, cfg.embed_dim)).astype(np.float32)
    hv = np.ones((2, cfg.max_seq_len), bool)
    hv[0, :6] = False
    hv[1, :1] = False
    rt, rv = JCompression(cfg).apply({"params": p["compress"]}, jnp.asarray(h), jnp.asarray(hv))
    gt, gv = tower.compress(torch.as_tensor(h), torch.as_tensor(hv))
    close(gt, rt, F32_TOL)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


# -- the tower ---------------------------------------------------------------

MODES = ("call", "causal_call", "all_position_interests", "interests_at_position",
         "masked_position_outputs", "item_embeddings", "compute_scores")


def run_mode(mode, batch, model, params, tower):
    """(JAX output, port output) of one tower mode on the batch."""
    jf, jv = jax_in(batch)
    tf, tv = torch_in(batch)
    b = len(batch["history_valid"])
    if mode in ("call", "causal_call"):
        return model.apply(params, jf, jv), tower(tf, tv)
    if mode == "all_position_interests":
        return (model.apply(params, jf, jv, method=JTower.all_position_interests),
                tower.all_position_interests(tf, tv))
    if mode == "interests_at_position":
        pos = np.arange(b) * 3 % 6
        return (model.apply(params, jf, jv, jnp.asarray(pos), method=JTower.interests_at_position),
                tower.interests_at_position(tf, tv, torch.as_tensor(pos)))
    if mode == "masked_position_outputs":
        l = tower.config.max_seq_len
        mp = np.stack([np.array([l - 1 - i % 3, l - 5 + i % 2]) for i in range(b)])
        return (model.apply(params, jf, jv, jnp.asarray(mp),
                            method=JTower.masked_position_outputs),
                tower.masked_position_outputs(tf, tv, torch.as_tensor(mp)))
    if mode == "item_embeddings":
        return (model.apply(params, jf, method=JTower.item_embeddings),
                tower.item_embeddings(tf))
    interests = model.apply(params, jf, jv)
    cands = model.apply(params, jf, method=JTower.item_embeddings)  # [B, L, D]
    return (jnp.stack([JTower.compute_scores(interests, cands[:, 3]),
                       JTower.compute_scores(interests, cands).reshape(b, -1)[:, :b]]),
            torch.stack([RetrievalTower.compute_scores(tower(tf, tv), tower.item_embeddings(tf)[:, 3]),
                         RetrievalTower.compute_scores(tower(tf, tv),
                                                       tower.item_embeddings(tf)).reshape(b, -1)[:, :b]]))


@pytest.mark.parametrize("mode", MODES)
def test_tower_modes_match_at_f32(mode, f32_setup):
    cfg, batch, model, params, tower = f32_setup
    if mode == "causal_call":
        cfg = dataclasses.replace(cfg, use_causal_mask=True)
        model = JTower(cfg)
        tower = load_tower(port_cfg(cfg), tower.state_dict(), torch.device("cpu"))
    with torch.no_grad():
        ref, got = run_mode(mode, batch, model, params, tower)
    close(got, ref, F32_TOL)


def test_interests_at_position_equals_its_row_of_all_positions(f32_setup):
    _, batch, _, _, tower = f32_setup
    tf, tv = torch_in(batch)
    pos = torch.tensor([0, 2, 4, 5])
    with torch.no_grad():
        allpos = tower.all_position_interests(tf, tv)
        got = tower.interests_at_position(tf, tv, pos)
    close(got, allpos[torch.arange(4), pos], F32_TOL)


@pytest.mark.parametrize("mode", ("call", "all_position_interests", "item_embeddings"))
def test_tower_modes_match_at_bf16(mode, f32_setup):
    """The float32 weights computing in bf16 on both sides (measured on
    the CPU: at most 1.6e-2 of max|ref| over every mode)."""
    cfg, batch, _, params, tower = f32_setup
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = JTower(cfg)
    tower = load_tower(port_cfg(cfg), tower.state_dict(), torch.device("cpu"))
    with torch.no_grad():
        ref, got = run_mode(mode, batch, model, params, tower)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(ref, np.float32), BF16_TOL)


def test_init_retrieval_params_follows_the_initializer_rules():
    cfg = port_cfg(tiny_cfg(video_vocab_size=4000))
    sd = init_retrieval_params(cfg, seed=1, device="cpu")
    with torch.device("meta"):
        ref = RetrievalTower(cfg).state_dict()
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}
    assert all(sd[k].dtype == torch.float32 for k in sd)
    assert torch.equal(sd["final_norm.scale"], torch.ones(cfg.embed_dim))
    assert not sd["blocks.0.attn.q_proj.bias"].any()
    assert abs(sd["embed.tables.video_id.weight"].std().item() - 0.02) < 1e-3
    w = sd["blocks.0.ffn.down.weight"]  # lecun normal, fan_in = ffn_dim
    assert abs(w.std().item() - (1 / cfg.ffn_dim) ** 0.5) < 0.1 * (1 / cfg.ffn_dim) ** 0.5
    again = init_retrieval_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    # a segment kept raw has no encoder on either side
    assert not any(k.startswith("compress.segment_1") for k in sd)


def test_tower_dropout_is_seeded_and_remat_recomputes_the_same_masks(f32_setup):
    """Dropout draws each block's seed from the caller's generator: one seed
    gives one output, and ``use_remat`` (``torch.utils.checkpoint``)
    recomputes each block with the same masks, so output and gradients
    equal the plain run's."""
    cfg, batch, _, _, tower = f32_setup
    tf, tv = torch_in(batch)
    sd = tower.state_dict()

    def run(remat, seed):
        c = port_cfg(dataclasses.replace(cfg, dropout_rate=0.3, num_layers=1, use_remat=remat))
        model = RetrievalTower(c)
        model.load_state_dict(sd)
        out = model(tf, tv, deterministic=False, generator=torch.Generator().manual_seed(seed))
        out.square().sum().backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    plain, grads = run(False, 0)
    again, _ = run(False, 0)
    other, _ = run(False, 1)
    remat, remat_grads = run(True, 0)
    assert torch.equal(plain, again) and not torch.equal(plain, other)
    with torch.no_grad():
        assert not torch.equal(plain, tower(tf, tv))  # dropout did something
    torch.testing.assert_close(remat, plain, rtol=0, atol=0)
    assert grads.keys() == remat_grads.keys()
    for n in grads:
        torch.testing.assert_close(remat_grads[n], grads[n], rtol=1e-6, atol=1e-7)


# -- the factored masks ------------------------------------------------------

from recommend_tpu.models import retrieval as jretrieval  # noqa: E402
from recommend_tpu.ops.attention import padding_mask_bias as j_padding_mask_bias  # noqa: E402
from recommend_tpu_torch.models import retrieval as tretrieval  # noqa: E402
from recommend_tpu_torch.ops import attention as tattn  # noqa: E402


def _left_padded(b, t, seed):
    rng = np.random.default_rng(seed)
    valid = np.arange(t)[None, :] >= rng.integers(0, t + 1, size=(b, 1))
    valid[0] = True  # one full history
    return valid


@pytest.mark.parametrize("mode", ["single", "single_causal", "interleaved", "encoder"])
def test_factored_masks_sum_to_the_jax_dense_biases_bit_for_bit(mode):
    """Each tower mask the tower hands its blocks factored sums, part for
    part, to the JAX package's dense bias (the one the port built before)."""
    t, k = 11, 3
    valid = _left_padded(5, t, seed=len(mode))
    tv = torch.as_tensor(valid)
    if mode == "encoder":
        got = tattn.FactoredBias(None, tattn.padding_mask_bias(tv)[:, 0, 0])
        ref = j_padding_mask_bias(jnp.asarray(valid))
    elif mode == "interleaved":
        got = tretrieval._interleaved_causal_mask(tv, k)
        ref = jretrieval._interleaved_causal_bias(jnp.asarray(valid), k)
    else:
        causal = mode == "single_causal"
        got = tretrieval._single_prediction_mask(tv, k, causal)
        ref = jretrieval._single_prediction_bias(jnp.asarray(valid), k, causal)
    ref = np.asarray(ref)
    dense = got.dense().expand(ref.shape).numpy()
    assert dense.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(dense, ref)
    assert (got.structure is None) == (mode in ("single", "encoder"))
    if got.structure is not None:
        assert torch.equal(got.tiles, tattn.tile_classes(got.structure))
    # the interleaved mask's dense wrapper, which perfbench's counts read
    if mode == "interleaved":
        assert torch.equal(tretrieval._interleaved_causal_bias(tv, k), got.dense())


def test_the_mask_structures_are_built_once_per_shape():
    tv = torch.ones(2, 7, dtype=torch.bool)
    a = tretrieval._interleaved_causal_mask(tv, 2)
    b = tretrieval._interleaved_causal_mask(tv[:1], 2)
    assert a.structure is b.structure and a.tiles is b.tiles
    assert a.key.shape == (2, 21) and b.key.shape == (1, 21)
    with torch.inference_mode():  # a structure autograd may save later
        c = tretrieval._single_prediction_mask(torch.ones(1, 9, dtype=torch.bool), 2, True)
    assert not c.structure.is_inference()


GRAD_MODES = ("call", "causal_call", "all_position_interests", "masked_position_outputs")


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_tower_gradients_match_at_f32(mode, f32_setup):
    """The gradient of a fixed projection of each trained mode's output with
    respect to every parameter, against ``jax.grad`` (float32, F32_TOL x 10
    of each tensor's largest |value|: the gradients sum over the batch)."""
    cfg, batch, model, params, tower = f32_setup
    if mode == "causal_call":
        cfg = dataclasses.replace(cfg, use_causal_mask=True)
        model = JTower(cfg)
    tcfg = port_cfg(cfg)
    port = load_tower(tcfg, tower.state_dict(), torch.device("cpu")).requires_grad_(True)
    jf, jv = jax_in(batch)
    tf, tv = torch_in(batch)
    b, l = len(batch["history_valid"]), cfg.max_seq_len
    mp = np.stack([np.array([l - 1 - i % 3, l - 5 + i % 2]) for i in range(b)])

    def j_out(p):
        if mode == "all_position_interests":
            return model.apply(p, jf, jv, method=JTower.all_position_interests)
        if mode == "masked_position_outputs":
            return model.apply(p, jf, jv, jnp.asarray(mp), method=JTower.masked_position_outputs)
        return model.apply(p, jf, jv)

    def t_out():
        if mode == "all_position_interests":
            return port.all_position_interests(tf, tv)
        if mode == "masked_position_outputs":
            return port.masked_position_outputs(tf, tv, torch.as_tensor(mp))
        return port(tf, tv)

    w = np.random.default_rng(3).normal(size=np.shape(j_out(params))).astype(np.float32)
    j_grads = jax.grad(lambda p: (j_out(p) * w).sum())(params)
    ref = retrieval_params_from_flax(jax.device_get(j_grads), tcfg)
    (t_out() * torch.as_tensor(w)).sum().backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    checked = 0
    largest = max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        top = float(r.abs().max())
        if name.endswith("attn.k_proj.bias"):
            # softmax ignores a shift of a query's logits, so the true
            # gradient is 0 and both sides hold rounding noise
            assert float(got[name].abs().max()) <= F32_TOL * largest, name
            continue
        if top == 0.0:  # a parameter the mode does not reach
            assert got[name] is None or not bool(got[name].any()), name
            continue
        err = float((got[name] - r).abs().max()) / top
        assert err <= 10 * F32_TOL, (name, err)
        checked += 1
    assert checked > 10
