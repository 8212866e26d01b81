"""Rules the PyTorch/CUDA port keeps.

- ``recommend_tpu_torch``, ``chip_smoke.py``, ``quality_torch.py``,
  ``quality_torch_from_init.py``, ``graft_entry_torch.py`` and the
  profiling scripts import neither
  JAX (nor flax, optax, orbax) nor anything of the JAX package
  ``recommend_tpu``;
- the port's ``RankingConfig`` is the JAX package's, field for field;
- the engine, the initializers, the trainers and the retrieval entry points
  (``RetrievalIndex``, ``RealTimeRecommender``, ``RetrievalEvaluator``,
  ``RetrievalTrainer``) run on CUDA unless told otherwise, and raise without
  it; the trainer's
  ``checkpoint_dir`` writes nothing before a save;
- ``make_mesh`` runs on CUDA over NCCL unless told the CPU, and raises
  without CUDA; ``parallel/`` is under the import rule;
- ``chip_smoke.py`` drives phase R (retrieval serving), phase RT (the
  retrieval trainer, handed to R's index), phase L (LLM4Rec), phase N
  (the data layer) and phase P (the mesh paths over NCCL), whose gates no
  ``try`` swallows; the semantic-distill
  initializer and ``quality_torch.py`` need CUDA unless told the CPU;
- the entry points of ``examples_torch/`` are under the import rule, and
  raise without CUDA unless given ``--device cpu``; ``quality_torch.py
  --track onetrans`` exits without CUDA as its ML-1M track does; phase E of
  ``chip_smoke.py`` drives every script as its ``main`` runs it
  (``run(parse_args(argv))``), gates the quality track's AUCs above a
  floor, and no ``try`` swallows its gates; phase AB drives
  ``examples_torch/ablation_compression.py`` through its ``main``, counts
  no kernel launch in it, and no ``try`` swallows its gates;
- the measurement scripts of ``examples_torch/`` (``*_bench.py``) and
  ``graft_entry_torch.py`` are under the import rule, raise without CUDA
  unless told the CPU, and no ``except`` in them (or in
  ``parallel/launch.py``) swallows a failure; ``graft_entry_torch``'s tiny
  config is ``__graft_entry__``'s, field for field; phase M of
  ``chip_smoke.py`` drives each through its ``main`` and gates it, and
  phase R gates the int8 searches' recall against the exact scan;
- each CUDA entry point (band attention's nine, the norm's three) takes
  exactly the arguments its ctypes binding passes, and a build without nvcc
  raises;
- the bf16 calls of every forward (B2f, B4f, B3f, B1f) reach the
  tensor-core kernel of ``band_attention_fwd_sm90.cuh``, at every head width
  the kernels are instantiated for (B1f with its NS segment's maps); their
  float32 calls stay on the CUDA-core kernel, which is float32 only;
- the bf16 calls of B4b, B1b and B3b reach both tensor-core passes of
  ``band_attention_bwd_sm90.cuh`` and those of B2dq and B2dkv its dq and its
  dkv pass alone, at every head width; float32 calls stay on the CUDA-core
  passes, which are float32 only;
- the tensor-core backward encodes the maps of, and launches, only the
  passes a call names.
"""

import ast
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from recommend_tpu import config as jconfig
from recommend_tpu_torch import config as tconfig
from recommend_tpu_torch.ops import _build
from recommend_tpu_torch.ops import attention as tattn
from recommend_tpu_torch.ops import flash_attention as tfa
from recommend_tpu_torch.ops import normalization as tnorm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "recommend_tpu")


def _port_files():
    return sorted((ROOT / "recommend_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_serving.py", ROOT / "profile_training.py",
        ROOT / "profile_kernels.py", ROOT / "profile_retrieval.py", ROOT / "profile_mesh.py",
        ROOT / "quality_torch.py", ROOT / "quality_torch_from_init.py",
        ROOT / "graft_entry_torch.py"] + sorted((ROOT / "examples_torch").glob("*.py")) + sorted(
        (ROOT / "tools_torch").glob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_rule_spares_the_port_itself():
    assert _forbidden("recommend_tpu.config") and _forbidden("jax.numpy")
    assert _forbidden("recommend_tpu")
    assert not _forbidden("recommend_tpu_torch.ops.flash_attention")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_ranking_config_matches_field_for_field():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.RankingConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.RankingConfig)]
    assert tf == jf
    assert tconfig.RankingConfig().to_dict() == jconfig.RankingConfig().to_dict()
    cfg = jconfig.get_config("ranking_small", num_heads=2, use_flash_attention=True)
    assert tconfig.RankingConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_engine_without_cuda_raises_unless_told_cpu(monkeypatch):
    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
    from __graft_entry__ import _tiny_cfg
    from tests.test_torch_ranking import port_config

    cfg = port_config(_tiny_cfg())
    params = init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankingInferenceEngine(cfg, params)
    engine = RankingInferenceEngine(cfg, params, device="cpu")
    assert next(engine.model.parameters()).device.type == "cpu"


def test_init_params_without_cuda_raises_unless_told_cpu(monkeypatch):
    from recommend_tpu_torch.convert import init_params
    from __graft_entry__ import _tiny_cfg
    from tests.test_torch_ranking import port_config

    cfg = port_config(_tiny_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="init_params: no CUDA device"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    assert all(t.device.type == "cpu" for t in params.values())


def test_trainer_without_cuda_raises_unless_told_cpu(monkeypatch, tmp_path):
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
    from __graft_entry__ import _tiny_cfg
    from tests.test_torch_ranking import port_config

    cfg = port_config(_tiny_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RankingTrainer: no CUDA device"):
        RankingTrainer(cfg)
    state = RankingTrainer(cfg, device="cpu").init_state(seed=0)
    assert all(t.device.type == "cpu" for t in state.params.values())
    # checkpoint_dir makes its directory and writes nothing before a save
    ck = tmp_path / "ckpt"
    trainer = RankingTrainer(cfg, device="cpu", checkpoint_dir=str(ck))
    trainer.init_state(seed=0)
    assert ck.is_dir() and list(ck.iterdir()) == []


def test_make_mesh_without_cuda_raises_unless_told_cpu(monkeypatch):
    from recommend_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="^make_mesh: no CUDA device"):
        make_mesh()
    # the CPU named: gloo, which needs a process group first
    with pytest.raises(RuntimeError, match="^make_mesh: no process group"):
        make_mesh(device="cpu")


def test_cuda_entry_points_match_their_bindings():
    library = dict(tfa.LIBRARY)
    library.update({name: tnorm.LIBRARY for name in tnorm._SIGNATURES})
    library.update({name: tattn.LIBRARY for name in tattn._SIGNATURES})
    for name, argtypes in {**tfa._SIGNATURES, **tnorm._SIGNATURES,
                           **tattn._SIGNATURES}.items():
        src = (_build.CSRC / f"{library[name]}.cu").read_text()
        extern = src[src.index('extern "C"'):]
        m = re.search(rf"int {name}\(([^)]*)\)", extern)
        assert m, f"{name} is not an extern C entry point"
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, t in zip(params, argtypes):
            c_type = p.rsplit(" ", 1)[0]
            kind = "pointer" if "*" in c_type else c_type
            assert {"pointer": tfa._P, "int": tfa._I, "float": tfa._F}[kind] is t, (name, p)
    assert set(tfa._SIGNATURES) == set(tfa.LAUNCHES) == set(tfa.LIBRARY)
    # one entry point per Pallas kernel: four forward, five backward (B3b too)
    assert len(tfa._SIGNATURES) == 9 and tfa.LIBRARY["band_attn_mh_bwd"] == "band_attention_bwd"
    # the norm's three: forward, backward, dscale (no Pallas kernel behind them)
    assert set(tnorm._SIGNATURES) == set(tnorm.LAUNCHES) == {
        "rmsnorm_fwd", "rmsnorm_bwd", "rmsnorm_dscale"}
    # the tower attention's two (no Pallas kernel behind them), and the count
    # of the tower's calls on a card that took the plain path
    assert set(tattn._SIGNATURES) == {"tower_attn_fwd", "tower_attn_bwd"}
    assert set(tattn.LAUNCHES) == set(tattn._SIGNATURES) | {"tower_attn_plain"}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(library.values())
    # a new header would be hashed into every library's name (a rebuild of all)
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {
        "band_attention_common.cuh", "band_attention_fwd_sm90.cuh",
        "band_attention_bwd_sm90.cuh", "band_attention_sm90_common.cuh"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("band_attention")
    path = _build.library_path("band_attention")
    assert path.name.startswith("libband_attention-") and path.suffix == ".so"


def _entry_body(src: str, name: str) -> str:
    """The body of the extern C entry point ``name`` in ``src``."""
    extern = src[src.index('extern "C"'):]
    start = extern.index("{", re.search(rf"int {name}\(", extern).end())
    depth = 0
    for i in range(start, len(extern)):
        depth += {"{": 1, "}": -1}.get(extern[i], 0)
        if depth == 0:
            return extern[start:i + 1]
    raise AssertionError(f"{name}: unbalanced body")


def _block_after(src: str, opener: str) -> str:
    """The brace-balanced block that follows ``opener`` in ``src``."""
    start = src.index("{", src.index(opener))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"{opener}: unbalanced block")


def test_bf16_blocked_and_mh_forwards_dispatch_to_the_tensor_core_kernel():
    common = (_build.CSRC / "band_attention_common.cuh").read_text()
    sm90 = (_build.CSRC / "band_attention_sm90_common.cuh").read_text()
    header = (_build.CSRC / "band_attention_fwd_sm90.cuh").read_text()
    fwd = (_build.CSRC / "band_attention.cu").read_text()
    # the header's switch over Dh expands the shared list, which is _KERNEL_DH
    widths = re.search(r"#define BAND_ATTN_FOR_EACH_DH\(X\)(.*)", common).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", widths)) == tfa._KERNEL_DH
    dispatch = header[header.index("int fwd_bf16("):]
    assert "BAND_ATTN_FOR_EACH_DH(BAND_ATTN_SM90_CASE)" in dispatch
    # one kernel shape: a 64-row consumer warpgroup and a producer warp
    assert re.search(r"template <int DH, bool SEG>\s*__global__ void "
                     r"__launch_bounds__\(128 \+ 32, 2\)", header)
    # its wgmma and TMA wrappers come from the header it shares with the
    # tensor-core backward
    assert '#include "band_attention_sm90_common.cuh"' in header
    assert "wgmma.mma_async" in sm90 and "cp.async.bulk.tensor" in sm90
    # the forwards' source includes it; the backward's does not
    assert '#include "band_attention_fwd_sm90.cuh"' in fwd
    assert "band_attention_fwd_sm90" not in (_build.CSRC / "band_attention_bwd.cu").read_text()
    # launch() runs band_attn_kernel<DH>, float32 only: no source instantiates
    # a CUDA-core kernel for bf16
    launch = _block_after(fwd, "int launch(const Args& a")
    assert "dtype" not in launch and "BAND_ATTN_FOR_EACH_DH(BAND_ATTN_CASE)" in launch
    assert "band_attn_kernel<DH><<<" in fwd and "template <int DH>\n__global__" in fwd
    assert "bfloat16" not in fwd[fwd.index("namespace {"):fwd.index('extern "C"')]
    for name in ("band_attn_blocked_fwd", "band_attn_bh_fwd", "band_attn_mh_fwd",
                 "band_attn_segkv_fwd"):
        body = _entry_body(fwd, name)
        # bf16 returns from the tensor-core kernel before anything else runs;
        # float32 goes through launch() (code 0) and nothing else does
        bf16 = re.search(r"if \(dtype == 1\)[^;]*?return sm90::fwd_bf16\(", body)
        assert bf16 and bf16.start() == body.index("if ("), name
        rest = body[bf16.end():]
        assert "if (dtype != 0) return (int)cudaErrorInvalidValue;" in rest, name
        assert rest.count("return launch(a,") == 1 and "sm90" not in rest, name
    # B2f's and B4f's [BH, L, Dh] is H = 1
    for name in ("band_attn_blocked_fwd", "band_attn_bh_fwd"):
        assert _fwd_bf16_args(_entry_body(fwd, name))[8:10] == ["bh", "1"], name


def _fwd_bf16_args(body: str):
    """The arguments of the sm90::fwd_bf16 call in an entry point's body."""
    call = body[body.index("sm90::fwd_bf16(") + len("sm90::fwd_bf16("):]
    return [a.strip() for a in call[:call.index(");")].split(",")]


def test_the_segmented_forward_passes_its_ns_segment_and_the_others_none():
    """fwd_bf16 takes (q, k, v, k2, v2, bias, out, lse, B, H, Lq, L1, L2,
    ...): B1f hands it the NS keys, values and count, so L2 > 0 picks the
    kernel instance with the second segment (SEG = true) and its two extra
    tensor maps; B2f, B4f and B3f hand it none, and L2 = 0 picks the
    instance without that code."""
    header = (_build.CSRC / "band_attention_fwd_sm90.cuh").read_text()
    fwd = (_build.CSRC / "band_attention.cu").read_text()
    dispatch = header[header.index("inline int fwd_bf16("):]
    assert re.search(r"L2 > 0 \? launch<D, true>\([^)]*\)\s*\\?\s*: launch<D, false>\(",
                     dispatch)
    launch = header[header.index("cudaError_t launch(const void* q"):]
    assert "if (SEG && (!encode<DH>(&tk2, k2, width, p.L2, B)" in launch
    assert re.search(r"band_attn_fwd_sm90_kernel<DH, SEG><<<[^>]*>>>"
                     r"\(tq, tk, tv, tk2, tv2, to, p\)", launch)
    # each segment's tiles run in a loop of their own, the NS tiles from the
    # NS maps tiled from row 0, so the S tiles run the same code in both
    # instances
    kernel = header[header.index("band_attn_fwd_sm90_kernel(const"):]
    assert "for (int t = 0; t < n1; ++t) load_kv(t, &tk, &tv, t * KEYS);" in kernel
    assert "load_kv(t, &tk2, &tv2, (t - n1) * KEYS);" in kernel
    assert re.search(r"for \(int t = 0; t < n1; \+\+t\)\s*consume_tile<DH, false>\(", kernel)
    assert re.search(r"if \(SEG\)\s*for \(int t = n1; t < n_tiles; \+\+t\) \{[^}]*"
                     r"consume_tile<DH, true>\(sm, t, key0, p\.L2, p\.Lkv \+ key0,", kernel)
    seg = _fwd_bf16_args(_entry_body(fwd, "band_attn_segkv_fwd"))
    assert seg[3:5] == ["kns", "vns"] and seg[11:13] == ["ls", "n"], seg
    for name in ("band_attn_blocked_fwd", "band_attn_bh_fwd", "band_attn_mh_fwd"):
        args = _fwd_bf16_args(_entry_body(fwd, name))
        assert args[3:5] == ["nullptr", "nullptr"] and args[12] == "0", (name, args)


def test_chip_smoke_holds_the_bf16_blocked_forward_at_every_head_width():
    """The tensor-core kernel tiles each width of _KERNEL_DH its own way
    (chunk width, swizzle, PV product), and B2f reaches any of them once
    kv > 1024: the card check runs each at least once, at kv > 1024."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.KERNELS)["band_attn_blocked_fwd"]
    assert {s["dh"] for s in shapes if s["ls"] > 1024} == set(tfa._KERNEL_DH)
    label = chip_smoke.ptxas_label(
        "ptxas info : Compiling entry function "
        "'_ZN9band_attn4sm9025band_attn_fwd_sm90_kernelILi48EEEvN8CUtensorMapE' for 'sm_90a'")
    assert label == "band_attn_fwd_sm90_kernel<48>"
    # the instances with and without the second key segment read apart
    for seg, word in (("1", "true"), ("0", "false")):
        label = chip_smoke.ptxas_label(
            "ptxas info : Compiling entry function '_ZN9band_attn4sm9025band_attn_fwd_sm90_"
            f"kernelILi128ELb{seg}EEEvN8CUtensorMapES2_S2_S2_S2_S2_NS0_6ParamsE' for 'sm_90a'")
        assert label == f"band_attn_fwd_sm90_kernel<128, {word}>"


def test_chip_smoke_holds_the_bf16_bh_forward_at_its_heaviest_shape_and_every_width():
    """B4f's bf16 calls run the tensor-core forward, which tiles each width
    of _KERNEL_DH its own way: the card check holds it first at its heaviest
    main-path shape (TC's layer 0, the shape its JSON entry reports), then
    at serving C's shapes, at the edges of the tiling and at every width."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.KERNELS)["band_attn_bh_fwd"]
    assert shapes[0] == dict(b=2048, h=1, lq=181, ls=362, n=0, dh=64)
    assert dict(b=512, h=1, lq=103, ls=206, n=0, dh=64) in shapes  # C's batch forward
    assert {s["dh"] for s in shapes} == set(tfa._KERNEL_DH)
    assert all(s["h"] == 1 and s["n"] == 0 and s["ls"] <= tfa.FUSED_MAX_KV for s in shapes)
    assert any(s["lq"] < 64 for s in shapes)  # one query tile, rows past Lq
    assert any(s["lq"] > 64 and s["lq"] % 64 for s in shapes)  # a partial last query tile
    assert any(s["ls"] % 64 for s in shapes)  # the last key tile zero-filled
    assert any(not s.get("causal", True) for s in shapes)  # the band off
    assert any(s["b"] > 1 for s in shapes)  # make_inputs pads row 0 when n = 0
    assert chip_smoke.SOURCE["band_attn_bh_fwd"].endswith("band_attention_fwd_sm90.cuh")


def test_chip_smoke_holds_the_bf16_segmented_forward_at_its_edges():
    """B1f's tensor-core route tiles the NS segment on its own: the card
    check reaches each edge of that tiling (the segmented edge shapes of
    B1b), and the NS tile at a 64- and a 16-column chunk (Dh 64 and 48)."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.KERNELS)["band_attn_segkv_fwd"]
    # the JSON line's first shape stays the main path's heaviest: serving
    # phase B's batch forward, layer 1
    assert shapes[0] == dict(b=128, h=2, lq=364, ls=595, n=12, dh=128)
    assert all(s["n"] == 12 for s in shapes)
    assert any(s["lq"] < 64 for s in shapes)
    assert any(s["ls"] % 64 for s in shapes)
    assert any(s.get("padded_row") and s["b"] > 1 for s in shapes)
    assert any(not s.get("causal", True) for s in shapes)
    assert {64, 48} <= {s["dh"] for s in shapes}
    assert chip_smoke.SOURCE["band_attn_segkv_fwd"].endswith("band_attention_fwd_sm90.cuh")


def test_chip_smoke_holds_the_bf16_blocked_dkv_pass_at_its_edges():
    """B2dkv runs the tensor-core dkv pass at H = 1 and n = 0: the card
    check reaches, at Dh 128, Lq < 64, Lkv % 64 != 0 past 1024 keys, a fully
    padded row (make_inputs pads row 0 when n = 0) and the band off, and
    the other widths that reach it past 1024 keys (Dh 64 and 96), in bf16
    and f32 alike."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.BWD_KERNELS)["band_attn_blocked_bwd_dkv"]
    assert shapes[0] == dict(b=256, h=1, lq=607, ls=1214, n=0, dh=128)
    assert all(s["h"] == 1 and s["n"] == 0 and s["b"] > 1 for s in shapes)
    assert {64, 96} <= {s["dh"] for s in shapes if s["ls"] > 1024}
    edges = [s for s in shapes[1:] if s["dh"] == 128]
    assert any(s["lq"] < 64 for s in edges)
    assert any(s["ls"] % 64 and s["ls"] > 1024 for s in edges)
    assert any(not s.get("causal", True) for s in edges)
    assert chip_smoke.SOURCE["band_attn_blocked_bwd_dkv"].endswith("band_attention_bwd_sm90.cuh")
    # B2dq, the other half of the same backward, takes the tensor-core dq pass
    assert chip_smoke.SOURCE["band_attn_blocked_bwd_dq"].endswith("band_attention_bwd_sm90.cuh")


def test_chip_smoke_holds_the_bf16_bh_backward_at_every_width_and_blocked_dq_at_its_edges():
    """B4b runs both tensor-core passes at every width of _KERNEL_DH, each
    tiled its own way (64-, 32- or 16-column chunks), and B2dq the dq pass
    past 1024 keys: the card check holds B4b at every width and at the edges
    of the tiling, and B2dq at the same edges and widths as B2dkv, the other
    half of its backward; their heaviest main-path shapes come first (TC's
    and TB's layer 0), and ptxas lines name each pass's instance."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.BWD_KERNELS)
    bh = shapes["band_attn_bh_bwd"]
    assert bh[0] == dict(b=2048, h=1, lq=181, ls=362, n=0, dh=64)
    assert {s["dh"] for s in bh} == set(tfa._KERNEL_DH)
    assert all(s["h"] == 1 and s["n"] == 0 and s["ls"] <= tfa.FUSED_MAX_KV for s in bh)
    assert any(s["lq"] < 64 for s in bh)  # one query tile, rows past Lq
    assert any(s["ls"] % 64 for s in bh)  # the last key tile zero-filled
    assert any(not s.get("causal", True) for s in bh)  # the band off
    assert any(s["b"] > 1 for s in bh)  # make_inputs pads row 0 when n = 0
    dq = shapes["band_attn_blocked_bwd_dq"]
    assert dq[0] == dict(b=256, h=1, lq=607, ls=1214, n=0, dh=128)
    assert dq == shapes["band_attn_blocked_bwd_dkv"]
    assert all(s["ls"] > tfa.FUSED_MAX_KV and s["b"] > 1 for s in dq)
    assert any(s["lq"] < 64 for s in dq) and any(s["ls"] % 64 for s in dq)
    assert any(not s.get("causal", True) for s in dq)
    assert {64, 96, 128} <= {s["dh"] for s in dq}
    for name in ("band_attn_bh_bwd", "band_attn_blocked_bwd_dq"):
        assert chip_smoke.SOURCE[name].endswith("band_attention_bwd_sm90.cuh"), name
    for kernel in ("band_attn_bwd_dq_sm90_kernel", "band_attn_bwd_dkv_sm90_kernel"):
        label = chip_smoke.ptxas_label(
            f"ptxas info : Compiling entry function '_ZN9band_attn4sm90{len(kernel)}{kernel}"
            "ILi48EEEvNS0_7BwdMapsENS0_9BwdParamsE' for 'sm_90a'")
        assert label == f"{kernel}<48>"


def test_bf16_segkv_and_mh_backwards_at_dh128_dispatch_to_the_tensor_core_passes():
    """B1b, B3b and B4b reach both tensor-core passes and B2dq/B2dkv one
    pass each, at every width of the switch in bwd_bf16 (B1b and B3b no
    longer at Dh 128 alone); float32 stays on the CUDA-core passes, which
    are float32 only."""
    header = (_build.CSRC / "band_attention_bwd_sm90.cuh").read_text()
    bwd = (_build.CSRC / "band_attention_bwd.cu").read_text()
    # the backward's source includes the tensor-core passes, which share the
    # wrappers of the forward but not its kernel
    assert '#include "band_attention_bwd_sm90.cuh"' in bwd
    assert '#include "band_attention_sm90_common.cuh"' in header
    assert "band_attention_fwd_sm90" not in header
    # two passes, named so that chip_smoke's ptxas lines tell them apart: dq
    # a 64-row consumer warpgroup and a producer warp, two blocks to an SM;
    # dkv two warpgroups of 64 keys each, one block to an SM
    for kernel, bounds in (("band_attn_bwd_dq_sm90_kernel", r"128 \+ 32, 2"),
                           ("band_attn_bwd_dkv_sm90_kernel", r"DKV_WARPGROUPS \* 128, 1")):
        assert re.search(rf"template <int DH>\s*__global__ void __launch_bounds__\({bounds}\)"
                         rf"\s*{kernel}\(", header), kernel
        assert re.search(rf"{kernel}<DH>\s*<<<", header), kernel
    assert "constexpr int DKV_WARPGROUPS = 2;" in header
    # the dispatch takes every width of the shared list, as fwd_bf16 does,
    # and refuses any other
    dispatch = header[header.index("inline int bwd_bf16("):]
    assert "dh != 128" not in dispatch
    assert re.search(r"case D:\s*\\\s*return \(int\)launch_bwd<D>\(", dispatch)
    assert "BAND_ATTN_FOR_EACH_DH(BAND_ATTN_SM90_CASE)" in dispatch
    assert "default: return (int)cudaErrorInvalidValue;" in dispatch
    assert "launch_bwd<128>" not in header
    routes = (("band_attn_segkv_bwd", "DQ | DKV"), ("band_attn_mh_bwd", "DQ | DKV"),
              ("band_attn_bh_bwd", "DQ | DKV"), ("band_attn_blocked_bwd_dq", "DQ"),
              ("band_attn_blocked_bwd_dkv", "DKV"))
    for name, passes in routes:
        body = _entry_body(bwd, name)
        # the tensor-core route returns before anything else runs, with no
        # width guard; float32 (code 0) goes through launch(), and nothing
        # else does
        route = re.search(r"if \(dtype == 1\)[^;]*?return sm90::bwd_bf16\(", body)
        assert route and route.start() == body.index("if ("), name
        call, rest = body[route.end():].split(";", 1)
        # the passes it names: both, or one pass alone
        assert re.search(rf",\s*{re.escape(passes)}, stream\)$", call), (name, call)
        assert "if (dtype != 0) return (int)cudaErrorInvalidValue;" in rest, name
        assert rest.count("return launch(a,") == 1 and "sm90" not in rest, name
    # [BH, L, Dh] is H = 1 with no NS segment; B2dq passes no dk/dv, B2dkv
    # no dq, B4b all three
    for name, outs in (("band_attn_blocked_bwd_dq", ["dq", "nullptr", "nullptr"]),
                       ("band_attn_blocked_bwd_dkv", ["nullptr", "dk", "dv"]),
                       ("band_attn_bh_bwd", ["dq", "dk", "dv"])):
        body = _entry_body(bwd, name)
        args = [a.strip() for a in body[body.index("bwd_bf16(") + 9:].split(")")[0].split(",")]
        assert args[3:5] == ["nullptr", "nullptr"], (name, args)
        assert args[9:16] == [*outs, "nullptr", "nullptr", "bh", "1"], (name, args)
        assert args[18] == "0", (name, args)
    # launch() runs the float32 passes alone: no bf16 instance of the
    # CUDA-core passes is compiled
    launch = _block_after(bwd, "int launch(const BwdArgs& a")
    assert "dtype" not in launch and "BAND_ATTN_FOR_EACH_DH(BAND_ATTN_CASE)" in launch
    for kernel in ("band_attn_bwd_dq_kernel", "band_attn_bwd_dkv_kernel"):
        assert re.search(rf"template <int DH>\s*__global__ void __launch_bounds__\(NT\) "
                         rf"{kernel}\(", bwd), kernel
        assert f"{kernel}<DH><<<" in bwd, kernel
    assert "bfloat16" not in bwd[bwd.index("namespace {"):bwd.index('extern "C"')]


def test_the_tensor_core_backward_encodes_and_launches_only_the_named_passes():
    """launch_bwd encodes the maps both passes read (Q, dO, K, V and the NS
    segment's) for every call, each pass's outputs only when the call names
    that pass, and launches only the named passes; bwd_bf16 refuses an empty
    or unknown mask. One Pass enum serves both bodies."""
    header = (_build.CSRC / "band_attention_bwd_sm90.cuh").read_text()
    bwd = (_build.CSRC / "band_attention_bwd.cu").read_text()
    assert header.count("enum Pass { DQ = 1, DKV = 2 };") == 1 and "enum Pass" not in bwd
    launch = _block_after(header, "cudaError_t launch_bwd(")
    assert "int passes" in header[header.index("cudaError_t launch_bwd("):][:400]
    assert re.search(r"if \(\(passes & DQ\) && !encode<DH>\(&m\.dq, dq,", launch)
    dkv_maps = launch[launch.index("if ((passes & DKV) &&"):]
    dkv_maps = dkv_maps[:dkv_maps.index("return cudaErrorInvalidValue;")]
    for out in ("dk", "dv", "dk2", "dv2"):
        assert f"encode<DH>(&m.{out}, {out}," in dkv_maps, out
    # every output map is encoded under its pass's test and nowhere else
    for out in ("dq", "dk", "dv", "dk2", "dv2"):
        assert launch.count(f"&m.{out},") == 1, out
    dq_block = _block_after(launch, "if (passes & DQ) {")
    dkv_block = _block_after(launch, "if (passes & DKV) {")
    assert "band_attn_bwd_dq_sm90_kernel<DH><<<" in dq_block
    assert "band_attn_bwd_dkv_sm90_kernel<DH>" in dkv_block and "<<<" in dkv_block
    assert launch.count("<<<") == 2
    dispatch = header[header.index("inline int bwd_bf16("):]
    assert "passes <= 0 || (passes & ~(DQ | DKV))" in dispatch
    assert "p, B, passes," in dispatch


def test_chip_smoke_holds_the_tensor_core_backwards_at_their_edges():
    """The tensor-core passes tile each key segment on its own, and each
    width its own way; the card check reaches each edge of that tiling for
    B1b and B3b, in bf16 and f32, at Dh 128 and at Dh 64, 96, 48 and 16
    with several heads (a head's columns start at h·Dh)."""
    import chip_smoke

    shapes = dict((name, s) for name, _, s in chip_smoke.BWD_KERNELS)
    # the JSON line's first shape stays the main path's: TA's layer 0 (B3b's
    # are SG's, put first by main)
    assert shapes["band_attn_segkv_bwd"][0] == dict(b=512, h=2, lq=181, ls=350, n=12, dh=128)
    for name in ("band_attn_segkv_bwd", "band_attn_mh_bwd"):
        edges = shapes[name]
        assert all(s["h"] * s["dh"] * 2 % 16 == 0 for s in edges), name
        assert {s["dh"] for s in edges if s["h"] > 1} >= {128, 64, 96, 48, 16}, name
        assert any(s["lq"] < 64 for s in edges), name  # one query tile, rows past Lq
        assert any(s["ls"] % 64 for s in edges), name  # the last S tile zero-filled
        assert any(not s.get("causal", True) for s in edges), name  # the band off
        # a batch row whose S keys are all padded (make_inputs pads row 0)
        assert any(s["b"] > 1 and s.get("padded_row", s["n"] == 0) for s in edges), name
    assert any(s["ls"] % 64 and s["n"] == 12 for s in shapes["band_attn_segkv_bwd"])
    assert all(s["n"] == 0 for s in shapes["band_attn_mh_bwd"])
    assert chip_smoke.SOURCE["band_attn_segkv_bwd"].endswith("band_attention_bwd_sm90.cuh")
    assert chip_smoke.SOURCE["band_attn_mh_bwd"].endswith("band_attention_bwd_sm90.cuh")
    assert set(chip_smoke.SOURCE) == set(tfa.LAUNCHES)
    label = chip_smoke.ptxas_label(
        "ptxas info : Compiling entry function "
        "'_ZN9band_attn4sm9029band_attn_bwd_dkv_sm90_kernelILi128EEEvNS0_7BwdMapsENS0_9BwdParamsE' "
        "for 'sm_90a'")
    assert label == "band_attn_bwd_dkv_sm90_kernel<128>"


def _retrieval_setup():
    from recommend_tpu_torch.convert import init_retrieval_params

    cfg = tconfig.get_config("retrieval_small", embed_dim=32, num_layers=1, num_heads=2,
                             ffn_dim=64, max_seq_len=16, compression_schedule=((8, 4), (8, 1)),
                             video_vocab_size=500, compute_dtype="float32")
    return cfg, init_retrieval_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("entry", ["init_retrieval_params", "RetrievalIndex",
                                   "RealTimeRecommender", "RetrievalEvaluator"])
def test_retrieval_entry_points_without_cuda_raise_unless_told_cpu(monkeypatch, entry):
    from recommend_tpu_torch.convert import init_retrieval_params
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.serving.retrieval_service import (
        RealTimeRecommender, RetrievalIndex)

    cfg, params = _retrieval_setup()
    index = RetrievalIndex(cfg, params, device="cpu")
    make = {
        "init_retrieval_params": lambda **kw: init_retrieval_params(cfg, **kw),
        "RetrievalIndex": lambda **kw: RetrievalIndex(cfg, params, **kw),
        "RealTimeRecommender": lambda **kw: RealTimeRecommender(cfg, params, index, **kw),
        "RetrievalEvaluator": lambda **kw: RetrievalEvaluator(cfg, params, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"^{entry}: no CUDA device"):
        make()
    made = make(device="cpu")
    tensors = made.values() if isinstance(made, dict) else made.model.state_dict().values()
    assert all(t.device.type == "cpu" for t in tensors)


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def test_chip_smoke_drives_phase_r_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    phase = _function(tree, "retrieval_phase")
    main = _function(tree, "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and any(isinstance(a, ast.Name) and a.id == "retrieval_phase"
                     for a in [n.func, *n.args])]
    assert calls, "main does not run phase R"
    same_topk = _function(tree, "_same_topk")
    for fn in (phase, main, same_topk):
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    assert len([n for n in ast.walk(same_topk) if isinstance(n, ast.Assert)]) == 2
    gates = [ast.unparse(n.msg) for n in ast.walk(phase)
             if isinstance(n, ast.Assert) and n.msg is not None]
    gates += [n.args[0].value for n in ast.walk(phase) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name) and n.func.id == "_same_topk"]
    for gate in ("f32 tower, card vs CPU", "flat scan", "int8 scan", "two IVF builds differ",
                 "full-probe IVF", "recommended a seen item", "differ from index.search"):
        assert any(gate in g for g in gates), gate


def test_retrieval_trainer_without_cuda_raises_unless_told_cpu(monkeypatch):
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    cfg, _ = _retrieval_setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="^RetrievalTrainer: no CUDA device"):
        RetrievalTrainer(cfg)
    state = RetrievalTrainer(cfg, device="cpu").init_state(seed=0)
    assert all(t.device.type == "cpu" for t in state.params.values())


def test_chip_smoke_drives_phase_rt_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and any(isinstance(a, ast.Name) and a.id == "retrieval_training_phase"
                     for a in ast.walk(n))]
    assert calls, "main does not run phase RT"
    fns = [_function(tree, name) for name in
           ("retrieval_training_phase", "_card_vs_cpu_step", "_same_state", "main")]
    for fn in fns:
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    gates = [ast.unparse(n.msg) for fn in fns[:2] for n in ast.walk(fn)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in ("f32 step loss, card vs CPU", "f32 step grad norm", "f32 step gradients",
                 "adamw of the card's gradients", "f32 step {what} {name}", "two seeded runs' losses differ",
                 "two seeded runs' parameters differ", "resumed state differs",
                 "scatter budget dropped rows", "refreshed corpus differs",
                 "differs from a fresh index's"):
        assert any(gate in g for g in gates), gate
    # every mode takes the card-vs-CPU step
    phase = ast.unparse(fns[0])
    assert "('single', 'seq2seq', 'masked')" in phase


def test_the_new_modules_are_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("llm4rec/__init__.py", "llm4rec/prompts.py", "llm4rec/intent_cache.py",
                 "llm4rec/semantic_distill.py", "llm4rec/semantic_ids.py", "data/replica.py",
                 "data/datasets.py", "data/native.py", "parallel/__init__.py",
                 "parallel/mesh.py", "parallel/sharding.py", "parallel/embedding_sharding.py",
                 "training/base.py"):
        assert f"recommend_tpu_torch/{name}" in names, name
    assert {"chip_smoke.py", "quality_torch.py"} <= names


def test_semantic_distill_init_without_cuda_raises_unless_told_cpu(monkeypatch):
    from recommend_tpu_torch.convert import init_semantic_distill_params
    from recommend_tpu_torch.llm4rec import SemanticDistillConfig

    cfg = SemanticDistillConfig(teacher_dim=16, hidden_dim=8, num_heads=2, head_dim=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="^init_semantic_distill_params: no CUDA device"):
        init_semantic_distill_params(cfg)
    params = init_semantic_distill_params(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in params.values())


def test_quality_run_without_cuda_exits_unless_told_cpu(monkeypatch, tmp_path, capsys):
    import quality_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "q.json"
    assert quality_torch.main(["--output", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()


L_N_GATES = {
    "distill_phase": ("distill f32 step loss, card vs CPU", "distill f32 step gradients",
                      "L: distill loss"),
    "semantic_id_phase": ("two semantic-id builds differ", "not its nearest centroid",
                          "L: map_ids", "non-finite next-semantic-id loss"),
    "intent_phase": ("intent cache counts", "took the default intent",
                     "the intent reached the trainer changed", "does not move the logits",
                     "L: f32 loss differs", "L: f32 grad norm differs",
                     "L: f32 table gradients differ", "L: non-finite loss"),
    "data_phase": ("differs from the numpy path's", "alias sampler draws against"),
}


def test_chip_smoke_drives_phases_l_and_n_and_no_try_swallows_their_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    called = {n.id for n in ast.walk(main) if isinstance(n, ast.Name)}
    for name, gates in L_N_GATES.items():
        assert name in called, f"main does not run {name}"
        fn = _function(tree, name)
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], name
        found = [ast.unparse(n.msg) for n in ast.walk(fn)
                 if isinstance(n, ast.Assert) and n.msg is not None]
        for gate in gates:
            assert any(gate in g for g in found), (name, gate)
    assert not [n for n in ast.walk(main) if isinstance(n, ast.Try)]
    # the intent step's kernel launches go to the totals that the kernels line reports
    assert "time_train_steps(fa, totals," in ast.unparse(_function(tree, "intent_phase"))
    timed = ast.unparse(_function(tree, "time_train_steps"))
    assert "counted(fa, run, per_step, steps)" in timed and "totals[k] += got[k]" in timed


P_GATES = ("P: the process group runs", "P: mesh ranking losses differ",
           "P: mesh ranking parameters differ", "P: non-finite ranking loss",
           "P: mesh retrieval loss differs", "P: mesh retrieval grad norm differs",
           "P: mesh retrieval parameters differ", "P: mesh retrieval accumulators differ",
           "P: non-finite retrieval loss", "ids differ", "P: mesh index scores differ",
           "P: mesh fetch_items differs", "differs from the plain gather",
           "table gradient differs")


def test_chip_smoke_drives_phase_p_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    assert "mesh_phase" in {n.id for n in ast.walk(main) if isinstance(n, ast.Name)}
    fns = [_function(tree, name) for name in
           ("mesh_phase", "_p_ranking", "_p_retrieval_trainer", "_p_index", "_p_lookups",
            "main")]
    for fn in fns:
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    gates = [ast.unparse(n.msg) for fn in fns for n in ast.walk(fn)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in P_GATES:
        assert any(gate in g for g in gates), gate
    phase = ast.unparse(fns[0])
    # one NCCL rank on the card, no fallback to gloo there; its launches reach the totals
    assert "backend=None if on_card else 'gloo'" in phase
    assert "totals[name] += n" in phase
    # the ranking side counts its launches exactly
    assert "counted(fa, run, per_step, P_STEPS + P_TIMED)" in ast.unparse(fns[1])


EXAMPLES = {
    "train_ranking": ["--model_dir", "{tmp}/model"],
    "evaluate": ["ranking", "--checkpoint", "{tmp}/model"],
    "train_retrieval": ["--quick-start", "--model_dir", "{tmp}/model"],
    "serving_demo": ["--tiny"],
    "online_learning_demo": ["--model_dir", "{tmp}/model"],
}
# the measurement scripts, which phase M drives
MEASUREMENT = {
    "flagship_serving_bench": ["--output", "{tmp}/model"],
    "flagship_bench": ["--output", "{tmp}/model"],
    "serving_bench": ["--output", "{tmp}/model"],
    "lookup_bench": [],
    "scaling_bench": [],
}
# phase E drives EXAMPLES; phase AB the ablation
ENTRY_POINTS = {**EXAMPLES, **MEASUREMENT,
                "ablation_compression": ["--steps", "3", "--output", "{tmp}/model"]}


def test_the_entry_points_are_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"examples_torch/{name}.py" for name in ENTRY_POINTS} <= names


@pytest.mark.parametrize("script", sorted(ENTRY_POINTS))
def test_each_entry_point_raises_without_cuda_unless_told_cpu(monkeypatch, tmp_path, script):
    import importlib

    mod = importlib.import_module(f"examples_torch.{script}")
    argv = [a.format(tmp=tmp_path) for a in ENTRY_POINTS[script]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"^{script}: no CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "model").exists()  # nothing written before the device is known
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_quality_onetrans_track_without_cuda_exits_unless_told_cpu(monkeypatch, tmp_path,
                                                                  capsys):
    import quality_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "q.json"
    assert quality_torch.main(["--track", "onetrans", "--output", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()


E_GATES = ("E: train_ranking --flash launched", "E: evaluate launched",
           "E: evaluate's offline AUC differs", "the pushed engine's state differs",
           "E: the appended items left the index", "E: training did not go on",
           "E: quality_torch returned", "E: quality AUCs", "E_QUALITY_AUC_FLOOR", "lacks")


def test_chip_smoke_drives_phase_e_through_each_main_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    assert "entry_points_phase" in {n.id for n in ast.walk(main) if isinstance(n, ast.Name)}
    fns = [_function(tree, name)
           for name in ("entry_points_phase", "_driven", "_run", "_files", "main")]
    for fn in fns:
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    gates = [ast.unparse(n.msg) for fn in fns for n in ast.walk(fn)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in E_GATES:
        assert any(gate in g for g in gates), gate
    phase = ast.unparse(fns[0])
    # each script as its main runs it: run(parse_args(argv))
    assert "script.run(script.parse_args(argv))" in ast.unparse(fns[2])
    for script in EXAMPLES:
        assert f"_run({script}," in phase, script
    assert "quality_torch.main(" in phase
    # phase E's launches reach the kernels line's totals
    assert "totals[k] += v" in ast.unparse(fns[1])
    assert "fa.reset_launch_counts()" in ast.unparse(fns[1])


AB_GATES = ("AB: ablation_compression returned", "JSON lines, not 3", "keys", "AB: summary keys",
            "AB: arms", "not finite in [0, 1]")


def test_chip_smoke_drives_phase_ab_through_main_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    phase = _function(tree, "ablation_phase")
    for fn in (phase, main):
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    # run as main runs it, with no band-attention launch allowed
    assert "counted(fa, ablation_phase, {}, 1)" in ast.unparse(main)
    assert "ablation_compression.main(" in ast.unparse(phase)
    gates = [ast.unparse(n.msg) for n in ast.walk(phase)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in AB_GATES:
        assert any(gate in g for g in gates), gate


def test_graft_entry_without_cuda_raises_unless_told_cpu(monkeypatch):
    import graft_entry_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="^entry: no CUDA device"):
        graft_entry_torch.entry()
    with pytest.raises(RuntimeError, match="^dryrun_multichip: no CUDA device"):
        graft_entry_torch.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="^graft_entry_torch: no CUDA device"):
        graft_entry_torch.main([])


@pytest.mark.parametrize("n_ns", [4, 3])
def test_graft_tiny_config_matches_field_for_field(n_ns):
    import __graft_entry__
    import graft_entry_torch

    assert graft_entry_torch._tiny_cfg(n_ns).to_dict() == __graft_entry__._tiny_cfg(
        n_ns).to_dict()


def _handlers_swallow(path: Path):
    """Every ``except`` clause of a file: each must re-raise."""
    tree = ast.parse(path.read_text())
    return [h for n in ast.walk(tree) if isinstance(n, ast.Try) for h in n.handlers
            if not any(isinstance(x, ast.Raise) for x in ast.walk(h))]


@pytest.mark.parametrize("path", [
    *(f"examples_torch/{name}.py" for name in sorted(MEASUREMENT)),
    "graft_entry_torch.py", "recommend_tpu_torch/parallel/launch.py"])
def test_no_try_in_the_measurement_scripts_swallows_a_failure(path):
    assert not _handlers_swallow(ROOT / path), path


M_GATES = ("M: flagship_serving phases", "M: the flat search's recall",
           "M: int8 top-100 recall vs exact", "M: the scatter budget dropped rows",
           "M: serving_bench keys", "M: serving_bench --device-side keys",
           "M: entry() not finite", "launched")


def test_chip_smoke_drives_phase_m_through_each_main_and_gates_phase_r_int8_recall():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    phase = _function(tree, "measurement_phase")
    only = _function(tree, "_only")
    for fn in (phase, main, only):
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    assert "measurement_phase(fa, totals)" in ast.unparse(main)
    text = ast.unparse(phase)
    for script in MEASUREMENT:
        assert f"_run({script}," in text, script
    assert "graft_entry_torch.entry(device)" in text
    assert "graft_entry_torch.dryrun_multichip(1, device)" in text
    gates = [ast.unparse(n.msg) for fn in (phase, only) for n in ast.walk(fn)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in M_GATES:
        assert any(gate in g for g in gates), gate
    r_gates = [ast.unparse(n.msg) for n in ast.walk(_function(tree, "retrieval_phase"))
               if isinstance(n, ast.Assert) and n.msg is not None]
    assert any("top-100 recall vs exact" in g and "R_INT8_RECALL_MIN" in g for g in r_gates)


# each profiling tool with the arguments it needs besides --device
TOOLS = {"profile_bench": ["--no-trace", "--steps", "1"],
         "analyze_profile": ["{tmp}/trace.json"],
         "mfu_accounting": ["{tmp}/prof.json"],
         "aggregate_quality": ["quality_r05_seed0.json", "--output", "{tmp}/board.json"]}


def test_the_profiling_tools_are_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"tools_torch/{name}.py" for name in TOOLS} <= names
    assert {p.stem for p in (ROOT / "tools_torch").glob("*.py")} == set(TOOLS)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_each_profiling_tool_raises_without_cuda_unless_told_cpu(monkeypatch, tmp_path, tool):
    import importlib

    mod = importlib.import_module(f"tools_torch.{tool}")
    argv = [a.format(tmp=tmp_path) for a in TOOLS[tool]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"^{tool}: no CUDA device"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []  # nothing read or written before the device
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in (ROOT / "tools_torch").glob("*.py")))
def test_no_try_in_the_profiling_tools_swallows_a_failure(path):
    assert not _handlers_swallow(ROOT / path), path


T_GATES = ("T: profile_bench", "launched", "loss", "T: the trace holds no kernel event",
           "T: the band-attention rollup names", "T: sparse_embed slice")


def test_chip_smoke_drives_phase_t_through_the_tools_and_no_try_swallows_its_gates():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = _function(tree, "main")
    phase = _function(tree, "profile_phase")
    for fn in (phase, main, _function(tree, "l_kernel_shapes")):
        assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)], fn.name
    assert "profile_phase(fa, totals)" in ast.unparse(main)
    text = ast.unparse(phase)
    for call in ("_run(profile_bench,", "analyze_profile.run(", "mfu_accounting.run(",
                 "t_launches_per_step("):
        assert call in text, call
    gates = [ast.unparse(n.msg) for n in ast.walk(phase)
             if isinstance(n, ast.Assert) and n.msg is not None]
    for gate in T_GATES:
        assert any(gate in g for g in gates), gate
    m_gates = [ast.unparse(n.msg) for n in ast.walk(_function(tree, "measurement_phase"))
               if isinstance(n, ast.Assert) and n.msg is not None]
    assert any("device steps overlapped the save" in g for g in m_gates)
