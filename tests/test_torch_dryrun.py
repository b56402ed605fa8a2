"""The port's dry run (``repro_torch.launch.{specs,roofline,steps,dryrun}``)
against the JAX package's dry-run tooling, and against live runs.

* **specs**: every (arch, shape) of ``ALL_ARCHS + EXTRA_ARCHS`` gives the
  input spec shapes and dtypes of ``repro.launch.specs``; granite-3-2b,
  olmoe-1b-7b and mamba2-1.3b at full width give ``jax.eval_shape``'s
  parameter leaves (the period-stacked tree) and cache leaves.
* **roofline**: ``model_flops`` is the reference's; ``roofline_from_stats``
  gives the reference's terms up to the ratio of the hardware constants.
* **graph cells**: the reference's ``run_graph_cell`` runs once in a
  subprocess with 32 forced host devices (started at the module's start),
  psum and pencil at 8 and 32 ranks (n = 4096, SETUP_2; S = 1 and 8 at
  SETUP_1).  The port's cells on the same described meshes, float32, have
  the same effective mode and collective kinds, and every kind's bytes and
  the payload equal the reference's to the byte (``GRAPH_TOL`` = 0, the
  tolerance the first run allowed); the reference tests' ratios hold.
* **graph-serve cell**: rows pad to the mesh; the port's tick sorts each
  rank's rows locally, so it moves nothing (payload 0 <= 512 x rows; the
  reference's global sort under XLA moves a few hundred bytes a row).
* **LM cells**: the counterparts of the two reference dry-run tests that
  are red on jax 0.9.0: reduced granite on a described (4, 4) mesh, two
  microbatches, traces with FLOPs and collective bytes; its decode cell
  traces with ``_serve_replicated`` true.
* **dry run = live run**: at (2, 2) and (1, 4), for reduced granite, olmoe
  and mamba2, the dry run of train, prefill and decode as rank r counts
  exactly the ``Mesh.traffic`` / ``traffic_axes`` and ``FlopCounterMode``
  FLOPs that rank r counts in a live run of the same step on four gloo
  ranks (one ``RankPool``, one torch thread a rank; rank side in
  ``tests/_torch_serve_cases.py``).
* **meta wrappers**: each kernel wrapper on ``meta`` returns the kernel's
  shape, counts a launch and its ``work``, and never calls its plain
  version (the CPU path: the kernels' own test files).
* **described mesh**: collectives on meta give a live rank's shapes and
  counts, create no process group and refuse a real tensor.
* **CLI**: ``python -m repro_torch.launch.dryrun --arch granite-3-2b
  --shapes train_4k --mesh single --graph --graph-n 4096`` exits 0 and
  writes its JSON (a subprocess started at the module's start).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _torch_serve_cases as C
from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import nfft_window as twin
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as trl
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import RankPool
from repro_torch.launch.steps import _serve_replicated, trace_call, trace_cell
from repro_torch.models.common import whole_parts
from repro_torch.runtime import durable
from repro_torch.training.train_loop import TrainConfig
from repro_torch.tree import tree_flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
GRAPH_TOL = 0.0  # relative, payload and bytes by kind: equal to the byte
# (P, setup, mode, bank) of the graph cells held against the reference
GRAPH_CELLS = [(p, "setup2", mode, 1) for p in (8, 32)
               for mode in ("psum", "pencil")] + \
    [(8, "setup1", mode, bank) for mode in ("psum", "pencil")
     for bank in (1, 8)]
MESH_OF = {8: (2, 4), 32: (8, 4)}
FULL_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "mamba2-1.3b")
LIVE_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "mamba2-1.3b")
LIVE_MESHES = [(2, 2), (1, 4)]

_REF_GRAPH = """
import json, numpy as np, jax
from jax.sharding import Mesh
from repro.launch.dryrun import run_graph_cell
devs = np.array(jax.devices())
meshes = {8: Mesh(devs[:8].reshape(2, 4), ("data", "model")),
          32: Mesh(devs[:32].reshape(8, 4), ("data", "model"))}
out = {}
for p, setup, mode, bank in %r:
    r = run_graph_cell(4096, 3, False, setup_name=setup, spectral_mode=mode,
                       mesh=meshes[p], bank_size=bank)
    assert r["status"] == "ok", r.get("error")
    out[f"{p} {setup} {mode} {bank}"] = {
        "eff": r["spectral_mode_effective"],
        "payload": r["hlo_stats"]["collective_payload_bytes"],
        "by_kind": r["hlo_stats"]["collective_by_kind"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The two subprocesses, started together at the module's start: the
    reference's graph cells on 32 forced host devices, and the port's
    CLI."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=32")
    ref = subprocess.Popen([sys.executable, "-c",
                            textwrap.dedent(_REF_GRAPH % (GRAPH_CELLS,))],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shapes", "train_4k", "--mesh", "single",
         "--graph", "--graph-n", "4096", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {"ref": ref, "cli": cli}
    yield SimpleNamespace(procs=procs, out=out, done={})
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish(background, name):
    if name not in background.done:
        stdout, stderr = background.procs[name].communicate(timeout=600)
        background.done[name] = (background.procs[name].returncode, stdout,
                                 stderr)
    return background.done[name]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", threads=1) as ranks:
        yield ranks


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _jax_dtype_name(x) -> str:
    return str(np.dtype(x.dtype))


@pytest.mark.parametrize("arch", [c.name for c in
                                  tconfigs.ALL_ARCHS + tconfigs.EXTRA_ARCHS])
def test_input_specs_match_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for js, ts in zip(jcfg.shapes, tcfg.shapes):
        assert (js.name, js.kind) == (ts.name, ts.kind)
        for fn in ("train_input_specs", "prefill_input_specs",
                   "decode_input_specs"):
            want = getattr(jspecs, fn)(jcfg, js)
            got = getattr(tspecs, fn)(tcfg, ts)
            assert sorted(want) == sorted(got), (arch, fn)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert got[k].device.type == "meta"
                assert str(got[k].dtype).replace("torch.", "") == \
                    _jax_dtype_name(want[k]), (arch, fn, k)


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_abstract_params_and_caches_match_eval_shape(arch):
    """Full width: the meta model's period-stacked parameter tree, leaf
    by leaf (the JAX package's paths, which ``params_from_arrays`` maps to
    the port's names), and every layer's cache fields, against
    ``jax.eval_shape`` of the JAX package's ``init_params`` and
    ``init_caches``."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(
        jspecs.abstract_params(jcfg))[0]
    got = tree_flatten_with_path(tspecs.abstract_params(tcfg)
                                 .stack_for_training())
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == _jax_dtype_name(w)
    jc = jspecs.abstract_caches(jcfg, 2, 1024)
    tc = tspecs.abstract_caches(tcfg, 2, 1024)
    plan = JM.make_layer_plan(jcfg)
    npre, nper = len(plan.prefix), len(plan.period)
    assert len(tc) == jcfg.num_layers
    for i, cache in enumerate(tc):
        if i < npre:
            ref, lead = jc["prefix"][i], ()
        else:
            ref = jc["stack"][(i - npre) % nper]
            lead = (plan.n_periods,)
        assert type(cache)._fields == type(ref)._fields, i
        for t, r in zip(cache, ref):
            assert t.device.type == "meta"
            assert lead + tuple(t.shape) == tuple(r.shape), i
            assert str(t.dtype).replace("torch.", "") == _jax_dtype_name(r)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_model_flops_and_roofline_terms_are_the_reference_s():
    for kind in ("train", "prefill", "decode"):
        assert trl.model_flops(kind, 2.5e9, 256, 4096) == \
            jrl.model_flops(kind, 2.5e9, 256, 4096)
    stats = SimpleNamespace(flops=3.1e14, hbm_bytes=7.7e11,
                            collective_bytes=1.3e11, dci_bytes=2e9)
    want = jrl.roofline_from_stats(stats, kind="train", active_params=2.5e9,
                                   batch=256, seq=4096, chips=256)
    got = trl.roofline_from_stats(stats, kind="train", active_params=2.5e9,
                                  batch=256, seq=4096, chips=256)
    # the same terms, each times its constant: the reference's TPU v5e
    # figures over the port's H100 data-sheet figures
    assert got.compute_s * trl.PEAK_FLOPS["bfloat16"] == pytest.approx(
        want.compute_s * jrl.PEAK_FLOPS, rel=1e-12)
    assert got.memory_s * trl.HBM_BW == pytest.approx(
        want.memory_s * jrl.HBM_BW, rel=1e-12)
    assert got.collective_s * trl.LINK_BW == pytest.approx(
        want.collective_s * jrl.LINK_BW, rel=1e-12)
    for key in ("flops", "bytes_accessed", "comm_bytes", "dci_bytes",
                "model_flops_per_chip", "useful_flop_ratio"):
        assert getattr(got, key) == getattr(want, key), key
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    # the f32 and f64 cells take the peaks outside the tensor cores
    f32 = trl.roofline_from_stats(stats, kind="train", active_params=1.0,
                                  batch=1, seq=1, chips=1, dtype="float32")
    assert f32.compute_s == stats.flops / 67e12


def test_collective_models_are_the_reference_s():
    """The reference's "moved" and "payload" bytes of each kind, from a
    described rank's record of (kind, operand bytes, group size)."""
    recs = [("all_gather", 100, ("data",), 4, (0, 48)),
            ("reduce_scatter", 400, ("model",), 4, (16, 19)),
            ("all_reduce", 50, ("pod", "data"), 32, (3, 499)),
            ("all_reduce_max", 8, ("model",), 16, (256, 271)),
            ("all_to_all", 64, ("model",), 16, (240, 255))]
    got = trl.collective_stats(recs)
    assert got["collective_by_kind"] == {"all-gather": 400,
                                         "reduce-scatter": 400,
                                         "all-reduce": 116, "all-to-all": 64}
    assert got["collective_bytes"] == 980
    assert got["collective_payload_bytes"] == 100 + 100 + 116 + 64
    assert got["dci_bytes"] == 100
    assert got["collective_ops"] == 5


# ---------------------------------------------------------------------------
# the described mesh and the kernel wrappers on meta
# ---------------------------------------------------------------------------

def test_described_rank_counts_what_a_live_rank_would():
    m = Mesh({"data": 2, "model": 4}, rank=6, described=True)
    assert m.coords() == {"data": 1, "model": 2}
    t = torch.empty((8, 3), device="meta")
    assert tuple(m.psum(t, "model").shape) == (8, 3)
    assert tuple(m.pmax(t, "data").shape) == (8, 3)
    assert tuple(m.psum_scatter(t, "model", 0).shape) == (2, 3)
    assert tuple(m.all_gather(t, ("data", "model"), 1).shape) == (8, 24)
    assert tuple(m.all_to_all(t, "model", 0, 1).shape) == (2, 12)
    z = torch.empty((4,), dtype=torch.complex64, device="meta")
    assert m.all_gather(z, "data", 0).dtype == torch.complex64
    n = 8 * 3 * 4
    assert dict(m.traffic) == {
        "all_reduce": n, "all_reduce_max": n, "reduce_scatter": n,
        "all_gather": n + 4 * 8, "all_to_all": n,
        "wire": round(1.5 * n) + round(n) + round(0.75 * n) + 7 * n
        + 4 * 8 + round(0.75 * n)}
    assert m.traffic_axes["all_gather", ("data", "model")] == n
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="meta"):
        m.psum(torch.zeros(3), "model")
    with pytest.raises(ValueError):
        Mesh({"data": 2}, rank=2, described=True)


def _poison(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran on meta")
    for mod, name in ((twin, "window_spread_plain"),
                      (twin, "window_gather_plain"),
                      (tkm, "kernel_matvec_plain"),
                      (tfa, "flash_attention_plain")):
        monkeypatch.setattr(mod, name, plain)


def test_kernel_wrappers_on_meta_count_their_work(monkeypatch):
    n, d, taps, pad, c = 50, 3, 8, 40, 2
    meta = dict(device="meta")
    base = torch.empty((n, d), dtype=torch.int32, **meta)
    w = torch.empty((n, d, taps), dtype=torch.float32, **meta)
    x = torch.empty((n, c), dtype=torch.float32, **meta)
    grid = torch.empty((pad,) * d + (c,), dtype=torch.float32, **meta)
    a = torch.empty((30, 2), dtype=torch.float64, **meta)
    b = torch.empty((70, 2), dtype=torch.float64, **meta)
    v = torch.empty((70, 4), dtype=torch.float64, **meta)
    q = torch.empty((2, 8, 16, 64), dtype=torch.bfloat16, **meta)
    k = torch.empty((2, 2, 16, 64), dtype=torch.bfloat16, **meta)
    card = (twin.window_spread.launches,
            twin.window_spread_deterministic.launches,
            twin.window_gather.launches, tkm.kernel_matvec.launches,
            tfa.flash_attention.launches)
    _poison(monkeypatch)
    mesh = Mesh({"data": 1}, rank=0, described=True)

    def run():
        with durable.deterministic():
            det = twin.window_spread(x, base, w, padded_size=pad)
        return (twin.window_spread(x, base, w, padded_size=pad), det,
                twin.window_gather(grid, base, w),
                tkm.kernel_matvec(a, b, v, kernel_name="laplacian_rbf"),
                tfa.flash_attention(q, k, k, causal=True))

    out = trace_call(mesh, run)
    spread, det, gather, km, fa = run()
    assert tuple(spread.shape) == tuple(det.shape) == (pad,) * d + (c,)
    assert tuple(gather.shape) == (n, c)
    assert tuple(km.shape) == (30, 4) and km.dtype == torch.float64
    assert tuple(fa.shape) == tuple(q.shape) and fa.dtype == torch.bfloat16
    assert all(t.device.type == "meta"
               for t in (spread, det, gather, km, fa))
    # the launches are the trace counter's, one each inside the trace and
    # none outside it; the card's counts do not move
    assert (twin.window_spread.launches,
            twin.window_spread_deterministic.launches,
            twin.window_gather.launches, tkm.kernel_matvec.launches,
            tfa.flash_attention.launches) == card
    kern = out["stats"].kernels
    assert {name: k["launches"] for name, k in kern.items()} == dict.fromkeys(
        ("window_spread", "window_spread_deterministic", "window_gather",
         "kernel_matvec", "flash_attention"), 1)
    fw = twin.work(n, d, taps, c, pad, "float32")
    for name in ("window_spread", "window_spread_deterministic",
                 "window_gather"):
        assert (kern[name]["flops"], kern[name]["bytes"]) == fw
    # the deterministic wrapper itself, called on a meta grid
    with trl.TraceCounter() as counter:
        assert twin.window_spread_deterministic(x, base, w, grid,
                                                None) is grid
    assert counter.kernels["window_spread_deterministic"] == dict(
        launches=1, flops=fw[0], bytes=fw[1])
    assert (kern["kernel_matvec"]["flops"], kern["kernel_matvec"]["bytes"]) \
        == tkm.work(30, 70, 2, 4, "laplacian_rbf", "float64", True)
    assert (kern["flash_attention"]["flops"],
            kern["flash_attention"]["bytes"]) == \
        tfa.work(2, 8, 2, 16, 16, 64, True, 2)
    assert out["stats"].flops == sum(v["flops"] for v in kern.values())
    # nothing but the kernels moved bytes: the results were allocations
    assert out["stats"].hbm_bytes == sum(v["bytes"] for v in kern.values())


# ---------------------------------------------------------------------------
# graph cells
# ---------------------------------------------------------------------------

def _port_graph(p, setup, mode, bank):
    data, model = MESH_OF[p]
    rec = tdry.run_graph_cell(4096, 3, False, setup_name=setup,
                              spectral_mode=mode, bank_size=bank,
                              mesh=Mesh({"data": data, "model": model}))
    assert rec["status"] == "ok", rec.get("error")
    return rec


def test_graph_serve_cell_moves_nothing():
    mesh = Mesh({"data": 2, "model": 4})
    for chunk in (100, 200):
        rec = tdry.run_graph_serve_cell(8, chunk, 3, False,
                                        setup_name="setup1", mesh=mesh)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["kind"] == "graph_serve_tick" and rec["channels"] == 8
        assert rec["rows"] % 8 == 0 and rec["rows"] >= 8 * chunk
        st = rec["stats"]
        assert "all-reduce" not in st["collective_by_kind"]
        assert st["collective_payload_bytes"] <= 512 * rec["rows"]
        assert rec["note"] == tdry.GRAPH_SERVE_NOTE
        assert st["kernels"]["window_gather"]["launches"] == 1


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _reduced_granite():
    return tconfigs.reduced_config(tconfigs.get_config("granite-3-2b"),
                                   seq_len=64, global_batch=8)


def test_reduced_train_cell_traces_with_flops_and_collectives():
    """The counterpart of tests/test_dryrun_cell.py::
    test_reduced_cell_lower_compile_roofline: reduced granite on a described
    (4, 4) mesh, two microbatches."""
    cfg = _reduced_granite()
    out = trace_cell(cfg, cfg.shapes[0], Mesh({"data": 4, "model": 4}),
                     tc=TrainConfig(num_microbatches=2))
    assert out["kind"] == "train"
    st = out["stats"]
    assert st.flops > 0 and st.collective_bytes > 0 and st.hbm_bytes > 0
    mem = out["memory"]
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    roof = trl.roofline_from_stats(st, kind="train", active_params=1e6,
                                   batch=8, seq=64, chips=16,
                                   dtype="float32")
    assert roof.dominant in ("compute", "memory", "collective")


def test_decode_cell_traces_with_serving_replicated():
    """The counterpart of tests/test_dryrun_cell.py::
    test_decode_cell_serve_sharding."""
    cfg = _reduced_granite()
    mesh = Mesh({"data": 4, "model": 4})
    assert _serve_replicated(cfg, mesh)
    decode = next(s for s in cfg.shapes if s.kind == "decode"
                  and not s.skip_reason)
    out = trace_cell(cfg, decode, mesh, tc=TrainConfig(num_microbatches=1))
    assert out["kind"] == "decode" and out["replicated"] is True
    assert out["stats"].flops > 0


@pytest.mark.parametrize("arch,want", [
    ("granite-3-2b", []), ("olmoe-1b-7b", []), ("mamba2-1.3b", []),
    ("qwen1.5-32b", []), ("paligemma-3b", []),
    ("deepseek-v3-671b", ["attn: MLA"])])
def test_parts_computed_whole_are_named(arch, want):
    """A part that a 16-way "model" axis does not split computes whole on
    every rank; the dry run names it, since its counts overstate a split
    rank's work.  Only MLA and NFFT attention are such parts: heads and
    experts that the axis does not divide split in ceil blocks (qwen1.5-32b's
    40 heads, paligemma-3b's 8)."""
    cfg = tconfigs.get_config(arch)
    assert whole_parts(cfg, 16) == want
    assert whole_parts(cfg, 1) == []


def test_traced_cell_names_the_parts_computed_whole():
    cfg = _reduced_granite()  # 4 heads, 1 kv head: ceil blocks over 8
    decode = next(s for s in cfg.shapes if s.kind == "decode"
                  and not s.skip_reason)
    out = trace_cell(cfg, decode, Mesh({"data": 1, "model": 8}),
                     tc=TrainConfig(num_microbatches=1))
    assert out["whole_parts"] == []
    out = trace_cell(cfg, decode, Mesh({"data": 2, "model": 4}),
                     tc=TrainConfig(num_microbatches=1))
    assert out["whole_parts"] == []
    mla = tconfigs.reduced_config(tconfigs.get_config("deepseek-v3-671b"))
    decode = next(s for s in mla.shapes if s.kind == "decode"
                  and not s.skip_reason)
    out = trace_cell(mla, decode, Mesh({"data": 1, "model": 8}),
                     tc=TrainConfig(num_microbatches=1))
    assert out["whole_parts"] == ["attn: MLA"]


def _head_train_flops(cfg, tokens: int, seq: int, tc) -> int:
    """Matmul FLOPs of one q head of one layer in a train step over
    ``tokens`` tokens of ``seq``-token rows (MHA: one kv head a q head):
    its q, k, v and ``wo`` products and its causal-square attention, in
    the forward, the block's remat recompute and the backward (twice the
    forward's)."""
    d, hd = cfg.d_model, cfg.head_dim_eff
    forward = 4 * 2 * tokens * d * hd + 2 * 2 * tokens * seq * hd
    return (3 + tc.remat) * forward


def test_dry_run_counts_each_rank_its_ceil_block_of_heads():
    """qwen1.5-32b at train_4k on the 16 x 16 mesh: its 40 heads split in
    ceil blocks of 3 (ranks 0-12), 1 (rank 13) and 0 (ranks 14, 15).  The
    ranks differ only in attention (16 divides the hidden units and the
    vocabulary), so each rank's attention FLOPs over rank 15's are its
    heads' by the formula: 3 heads at rank 0, 1 at rank 13, none at rank
    15 (a rank that computed the 40 heads whole would count more than
    rank 0)."""
    cfg = tconfigs.get_config("qwen1.5-32b")
    assert cfg.num_heads == cfg.num_kv_heads == 40
    shape = next(s for s in cfg.shapes if s.name == "train_4k")
    tc = TrainConfig.for_arch(cfg)
    mesh = Mesh({"data": 16, "model": 16})
    flops = {r: trace_cell(cfg, shape, mesh, rank=r, tc=tc)["stats"]
             .matmul_flops for r in (0, 13, 15)}
    tokens = shape.global_batch // 16 * shape.seq_len
    head = cfg.num_layers * _head_train_flops(cfg, tokens, shape.seq_len, tc)
    assert flops[0] - flops[15] == 3 * head
    assert flops[13] - flops[15] == head


def test_skipped_cells_keep_their_reason():
    rec = tdry.run_cell("granite-3-2b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == next(
        s for s in tconfigs.get_config("granite-3-2b").shapes
        if s.name == "long_500k").skip_reason


@pytest.mark.parametrize("shape", LIVE_MESHES)
@pytest.mark.parametrize("arch", LIVE_ARCHS)
def test_dry_run_counts_what_the_live_run_counts(pool, arch, shape):
    for kind in ("train", "prefill", "decode"):
        outs = pool.run(C.live_and_dry, arch, shape, kind, 4)
        for r, (live, dry) in enumerate(outs):
            assert live["traffic"] == dry["traffic"], (kind, r)
            assert live["traffic_axes"] == dry["traffic_axes"], (kind, r)
            assert live["flops"] == dry["flops"], (kind, r)
            assert live["flops"] > 0
            if kind != "train":  # serving weights lie in their compute
                assert "all_to_all" not in live["traffic"], (kind, r)
        if shape[1] > 1:  # a model split moves bytes over "model"
            assert any(k.endswith("@model") for k in
                       outs[0][0]["traffic_axes"]), kind


def test_graph_cells_match_the_reference_and_its_ratios(background):
    port = {cell: _port_graph(*cell) for cell in GRAPH_CELLS}
    rc, stdout, stderr = _finish(background, "ref")
    assert rc == 0, stderr[-4000:]
    ref = json.loads(stdout.strip().splitlines()[-1])
    for cell, rec in port.items():
        want = ref[" ".join(map(str, cell))]
        st = rec["stats"]
        assert rec["spectral_mode_effective"] == want["eff"], cell
        assert set(st["collective_by_kind"]) == set(want["by_kind"]), cell
        for kind, nbytes in want["by_kind"].items():
            assert abs(st["collective_by_kind"][kind] - nbytes) \
                <= GRAPH_TOL * nbytes, (cell, kind)
        assert abs(st["collective_payload_bytes"] - want["payload"]) \
            <= GRAPH_TOL * want["payload"], cell

    def pay(p, setup, mode, bank=1):
        return port[p, setup, mode, bank]["stats"]["collective_payload_bytes"]

    # tests/test_dryrun_cell.py's ratios, on the port's numbers
    kinds32 = port[32, "setup2", "pencil", 1]["stats"]["collective_by_kind"]
    assert "all-reduce" not in kinds32
    assert abs(pay(8, "setup2", "psum") / pay(32, "setup2", "psum") - 1) < 0.05
    assert 3.0 < pay(8, "setup2", "pencil") / pay(32, "setup2", "pencil") < 5.0
    assert pay(32, "setup2", "pencil") < 0.6 * pay(32, "setup2", "psum")
    for mode in ("psum", "pencil"):
        assert 7.0 < pay(8, "setup1", mode, 8) / pay(8, "setup1", mode) < 9.0


def test_the_cli_writes_its_json(background):
    rc, stdout, stderr = _finish(background, "cli")
    assert rc == 0, stderr[-4000:]
    recs = json.loads((background.out / "dryrun.json").read_text())
    assert len(recs) == 13
    assert all(r["status"] == "ok" for r in recs)
    assert recs[0]["arch"] == "granite-3-2b" and recs[0]["mesh"] == "16x16"
    assert "13 ok, 0 skipped, 0 errors" in stdout
