"""The port's kernel selection (``parallel/kernelselect.py``) on the CPU,
held against the JAX package's: the 12 cases of
tests/test_kernelselect.py. Both packages run the same three corpora
(sparse int32 keys, float32 keys with ±0.0, small contiguous keys) and
must make the same ``(kernel, reason)`` decisions at the same sites,
with equal rows; with ``BIGSLICE_KERNEL_SELECT`` unset no selector
exists and the rows are today's, bit for bit.

Where the JAX package's probes land in its cross-session program cache,
the port compiles nothing: a second selector's probe builds nothing,
and its launches are attributed to the op under kind ``kselect``."""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.exec.meshexec import MeshExecutor as RefMesh  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.parallel import kernelselect as ref_ks  # noqa: E402
from bigslice_tpu.utils.telemetry import TelemetryHub as RefHub  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.exec import compile as port_compile  # noqa: E402
from bigslice_tpu_torch.exec.meshexec import MeshExecutor  # noqa: E402
from bigslice_tpu_torch.exec.session import Session  # noqa: E402
from bigslice_tpu_torch.exec.task import iter_tasks  # noqa: E402
from bigslice_tpu_torch.parallel import cuda_kernels as ck  # noqa: E402
from bigslice_tpu_torch.parallel import kernelselect as ks  # noqa: E402
from bigslice_tpu_torch.tools import slicetrace  # noqa: E402
from bigslice_tpu_torch.utils import devicetelemetry  # noqa: E402
from bigslice_tpu_torch.utils.telemetry import TelemetryHub  # noqa: E402
from test_torch_debughttp import counting_kernels  # noqa: E402

KW = dict(nkeys=1, nvals=1, ops=("add",), key_dtypes=("int32",),
          val_dtypes=("int32",), hash_eligible=True, dense_bound=False)
#: The JAX package's choose() also takes what its executor would do
#: without a selector; the port's eligibility already says so.
REF_KW = dict(KW, legacy_hash=True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("BIGSLICE_KERNEL_SELECT", "BIGSLICE_ADAPTIVE",
              "BIGSLICE_CODED", "BIGSLICE_SHUFFLE"):
        monkeypatch.delenv(k, raising=False)


def _sparse_keys(rows=4000, distinct=300, seed=7):
    """Classified int32 keys over a range auto-dense cannot take."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, distinct, rows).astype(np.int64)
    return ((k * 92821 + 17) % (1 << 30)).astype(np.int32)


def _corpora():
    rng = np.random.RandomState(11)
    floats = rng.randn(4000).astype(np.float32)
    floats[::101] = 0.0
    floats[1::101] = -0.0
    dense = rng.randint(0, 64, 4000).astype(np.int32)
    return {"hash": _sparse_keys(), "sort": floats, "dense": dense}


def _reduce_oracle(keys):
    out = {}
    for k in keys.tolist():
        out[k] = out.get(k, 0) + 1
    return out


def _count_pipeline(mod, keys):
    # One line for both packages: the same op names.
    return mod.Reduce(mod.Const(8, keys, np.ones(len(keys), np.int32)), lambda a, b: a + b)  # noqa: E501


def _port_run(pipeline_keys, arena=False, **kw):
    sess = Session(executor=MeshExecutor(device="cpu", staging_arena=arena),
                   **kw)
    res = sess.run(_count_pipeline(bst, pipeline_keys))
    return sorted(map(tuple, res.rows())), sess


def _ref_run(keys):
    mesh = Mesh(np.array(jax.devices()[:1]), ("shards",))
    sess = RefSession(executor=RefMesh(mesh, staging_arena=False))
    res = sess.run(_count_pipeline(ref_bs, keys))
    return sorted(map(tuple, res.rows())), sess


def _decisions(sel):
    return [(d["kernel"], d["reason"], d.get("site"), d.get("op"))
            for d in sel.stats.summary()["decisions"]]


# -------------------------------------------------------- env parsing


@pytest.mark.parametrize("env", ["", "off", "static", "MEASURED",
                                 " measured ", "frobnicate"])
def test_mode_from_env_parsing(env):
    try:
        want = ref_ks.mode_from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ks.mode_from_env(env)
        assert str(got.value) == str(e)
        return
    assert ks.mode_from_env(env) == want


def test_selector_from_env_chicken_bit(monkeypatch):
    assert ks.selector_from_env() is None
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "off")
    assert ks.selector_from_env() is None
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "static")
    sel = ks.selector_from_env(device="cpu")
    assert sel is not None and sel.mode == "static"
    assert sel.device.type == "cpu"
    assert ks.selector_from_env().device.type == "cuda"  # the default
    for name in ("MODES", "MAX_DECISIONS", "DEFAULT_PROBE_ROWS",
                 "MAX_PROBE_ROWS", "PROBE_MIN_MARGIN",
                 "PROBE_OVERRIDE_MARGIN", "PROBE_ITERS", "RESELECT_RATIO"):
        assert getattr(ks, name) == getattr(ref_ks, name), name


# -------------------------------------------------------- chicken bit


def test_session_chicken_bit_zero_samples():
    """Unset knob: no selector anywhere, today's rows, and neither the
    summary key nor a bigslice_kernel_select_* sample."""
    keys = _sparse_keys()
    rows, sess = _port_run(keys)
    assert dict(rows) == _reduce_oracle(keys)
    assert sess.kernel_select is None
    assert sess.executor.kernel_select is None
    assert sess.telemetry.kernel_select is None
    assert "kernel_select" not in sess.telemetry_summary()
    assert "kselect" not in sess.telemetry_summary()["device"]
    assert "bigslice_kernel_select" not in sess.telemetry.prometheus_text()


def test_selection_keys_decisions_not_plans(monkeypatch):
    """The selector's mode keys the compiled plan as the JAX package's
    does: every partitioned task's ``partition_config`` is the JAX
    package's 4-tuple (partitions, combiner, partition fn, the one-axis
    device signature), with the ``kselect:<mode>`` stamp once a mode is
    set, equal task for task to the JAX package's for the same slice on
    its one-device mesh. What the executor keys its lowerings on is the
    selector's decision per (op, site), the site named from the
    boundary's dtypes as the JAX package names it, and its probe per op
    shape, which ops of one shape share."""
    keys = np.arange(32, dtype=np.int32)

    def configs(tasks):
        # The op site, its #N re-invocation suffix dropped: each
        # package counts its own invocations of the line.
        return sorted((t.name.op.split("#")[0], t.name.shard,
                       getattr(t, "partition_config", None))
                      for t in iter_tasks(tasks))

    def both():
        port = Session(executor=MeshExecutor(device="cpu",
                                             auto_dense=False))
        res = port.run(_count_pipeline(bst, keys))
        mesh = Mesh(np.array(jax.devices()[:1]), ("shards",))
        ref = RefSession(executor=RefMesh(mesh, staging_arena=False))
        ref_res = ref.run(_count_pipeline(ref_bs, keys))
        assert sorted(map(tuple, res.rows())) == sorted(
            map(tuple, ref_res.rows()))
        return port, configs(res.tasks), configs(ref_res.tasks)

    _, unset, ref_unset = both()
    assert unset == ref_unset
    assert {c for _, _, c in unset} == {(1, False, False, (("shards",), (1,))),
                                        (8, True, False, (("shards",), (1,)))}
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "static")
    sess, got, ref_got = both()
    assert got == ref_got
    assert [c[:4] for _, _, c in got] == [c for _, _, c in unset]
    assert {c[4:] for _, _, c in got} == {("kselect:static",)}
    sel = sess.kernel_select
    sites = {(d["op"], d["site"]) for d in sel.stats.summary()["decisions"]}
    assert {site for _, site in sites} == {"k(int32)v(int32)"}
    assert len({op for op, _ in sites}) == len(sites) >= 2
    for op, site in sites:
        assert sel.decision(op, site) == "hash"
        assert sel.token(op) == ((site, "hash"),)
    # One probe for the ops of one shape; another value dtype is another
    # site, decided and probed on its own.
    calls = []

    def probe(self, opbase, sig, *a, **k):
        calls.append(sig)
        return {"winner": "hash", "walls_ms": {"hash": 1.0, "sort": 2.0}}

    monkeypatch.setattr(ks.KernelSelector, "_run_probe", probe)
    sel = ks.KernelSelector("measured", None, device="cpu")
    assert sel.choose("op-a", "k(int32)v(int32)", **KW) == "hash"
    assert sel.choose("op-b", "k(int32)v(int32)", **KW) == "hash"
    assert len(calls) == 1
    assert sel.choose("op-a", "k(int32)v(float32)",
                      **dict(KW, val_dtypes=("float32",))) == "hash"
    assert len(calls) == 2 and calls[1] != calls[0]
    assert [sel.decision(op, "k(int32)v(int32)")
            for op in ("op-a", "op-b", "op-c")] == ["hash", "hash", None]


# -------------------------------------- selection matrix, with parity


@pytest.fixture(scope="module")
def ref_matrix():
    """The JAX package's static decisions and rows on the three corpora
    (its one-device mesh), computed once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGSLICE_KERNEL_SELECT", "static")
        out = {}
        for want, keys in _corpora().items():
            rows, sess = _ref_run(keys)
            out[want] = (rows, _decisions(sess.kernel_select))
        return out


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "noarena"])
def test_selection_matrix_parity(arena, ref_matrix, monkeypatch):
    """sort against hash against dense, decided per boundary: each corpus
    takes the JAX package's (kernel, reason) at the same sites, and its
    rows equal the JAX package's (and, for the one boundary the selector
    decides, the unset run's, bit for bit)."""
    corpora = _corpora()
    base, base_sess = _port_run(corpora["hash"], arena=arena)
    assert base_sess.kernel_select is None
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "static")
    for want, keys in corpora.items():
        got, sess = _port_run(keys, arena=arena)
        ref_rows, ref_dec = ref_matrix[want]
        assert got == ref_rows, want
        if want == "hash":
            assert got == base
        else:
            assert dict(got) == _reduce_oracle(keys)
        dec = _decisions(sess.kernel_select)
        assert dec == ref_dec, want
        assert {d[0] for d in dec} == {want}
        reason = {"hash": "static:cpu-scatter-wins",
                  "sort": "hash-ineligible", "dense": "dense-bound"}[want]
        assert {d[1] for d in dec} == {reason}
        assert sess.telemetry_summary()["kernel_select"]["counts"][want]


def test_measured_mode_end_to_end(monkeypatch):
    """Measured mode on a device-executor run: once with the probe
    patched as the JAX package's test patches it (a hash win), equal to
    the JAX package's decisions under the same patch; once for real on
    the CPU, where both cores race. Rows equal the unset run's either
    way."""
    keys = _sparse_keys(rows=6000)
    base, _ = _port_run(keys)
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "measured")
    fake = {"winner": "hash", "walls_ms": {"hash": 1.0, "sort": 2.0}}
    with monkeypatch.context() as mp:
        mp.setattr(ks.KernelSelector, "_run_probe",
                   lambda self, *a, **k: dict(fake))
        mp.setattr(ref_ks.KernelSelector, "_run_probe",
                   lambda self, *a, **k: dict(fake))
        got, sess = _port_run(keys)
        _, ref_sess = _ref_run(keys)
    assert got == base
    assert _decisions(sess.kernel_select) == _decisions(
        ref_sess.kernel_select)
    assert {d["reason"] for d in sess.kernel_select.stats.summary()[
        "decisions"] if d["kernel"] == "hash"} == {"measured:probe"}
    got, sess = _port_run(keys)
    assert got == base
    probed = [d for d in sess.kernel_select.stats.summary()["decisions"]
              if d["reason"] in ("measured:probe", "measured:margin")]
    assert probed
    for d in probed:
        assert set(d["walls_ms"]) == {"sort", "hash"}
        assert all(len(v) == ks.PROBE_ITERS
                   for v in d["walls_all_ms"].values())
        assert d["probe_rows"] == ks.DEFAULT_PROBE_ROWS


# ------------------------------------------------- gates that move


def _misprobe_keys():
    """tests/test_torch_autodense.py's misprobe: 20 shards, wave 0 shows
    keys in [0, 8), the last shard holds 500_000, outside the bound
    discovered on wave 0."""
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 8, 20 * 64).astype(np.int32)
    keys[-64:] = 500_000
    return keys


def _counted_run(monkeypatch, keys, shards, **ex_kw):
    """One run of the count pipeline over ``shards`` shards, with K1's
    and K2's plain calls counted: (rows, session, launches)."""
    with monkeypatch.context() as mp:
        counting_kernels(mp)
        sess = Session(executor=MeshExecutor(device="cpu", **ex_kw))
        res = sess.run(bst.Reduce(bst.Const(shards, keys,
                                            np.ones(len(keys), np.int32)),
                                  lambda a, b: a + b))
        return sorted(map(tuple, res.rows())), sess, dict(ck.LAUNCHES)


@pytest.mark.parametrize("mode", ["static", "measured"])
def test_misprobe_decides_again(mode, monkeypatch):
    """A retracted dense bound drops the op's cached ``dense`` verdict:
    the group's rerun decides again, and is recorded, on the gates it
    now meets (phase 21's misprobe on the card, at a small size). Rows,
    retracted sites and K2 calls equal the unset run's."""
    keys = _misprobe_keys()
    base, base_sess, base_launches = _counted_run(monkeypatch, keys, 20)
    assert dict(base) == _reduce_oracle(keys)
    assert base_sess.executor.auto_dense_off
    assert base_launches["hash_aggregate"]
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", mode)
    _fake_probe(monkeypatch)
    got, sess, launches = _counted_run(monkeypatch, keys, 20)
    assert got == base
    assert launches == base_launches
    assert sess.executor.auto_dense_off == base_sess.executor.auto_dense_off
    sel = sess.kernel_select
    dec = [d for d in _decisions(sel) if d[0] != "reselect"]
    by_op = {}
    for d in dec:
        by_op.setdefault(d[3].split("@")[0], []).append(d[:2])
    hashed = "static:cpu-scatter-wins" if mode == "static" \
        else "measured:probe"
    # The producer's map side ran dense to its end; the reduce side saw
    # the key outside the bound, was retracted and ran again.
    assert by_op == {"const": [("dense", "dense-bound")],
                     "reduce": [("dense", "dense-bound"), ("hash", hashed)]}
    (op,) = [d[3] for d in dec if d[3].startswith("reduce")][-1:]
    assert sel.decision(op, "k(int32)v(int32)") == "hash"


def test_hash_overflow_decides_again(monkeypatch):
    """A hash table that overflowed puts the op on the sort path for
    good (``hash_off``) and drops its cached ``hash`` verdict: the rerun
    is recorded as the sort path it takes. Rows, the overflow list and
    K2 calls equal the unset run's."""
    from test_torch_hash_aggregate import _part

    cand = np.arange(200000, dtype=np.int32)
    keys = cand[_part([cand], 2) == 0][:4096]
    base, base_sess, base_launches = _counted_run(monkeypatch, keys, 2)
    assert base_sess.executor.hash_off
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "static")
    got, sess, launches = _counted_run(monkeypatch, keys, 2)
    assert got == base and launches == base_launches
    assert sess.executor.hash_off == base_sess.executor.hash_off
    sel = sess.kernel_select
    (off,) = [op for op in sess.executor.hash_off if op.startswith("const")]
    const = [d for d in _decisions(sel) if d[3] == off]
    assert [d[:2] for d in const] == [("hash", "static:cpu-scatter-wins"),
                                      ("sort", "hash-ineligible")]
    assert sel.decision(off, const[-1][2]) == "sort"


# ------------------------------------------- probes: no build, kselect


def test_probe_builds_nothing_and_launches_under_kselect(monkeypatch):
    """The JAX package's second Session probes from its program cache
    with zero compiles. The port compiles nothing: a second selector's
    probe adds no build, and each probe's launches (one warm-up and
    PROBE_ITERS timed calls of the hash core) are the op's under kind
    kselect, apart from its wave launches."""
    counting_kernels(monkeypatch)
    builds = []
    for _ in range(2):
        before = len(devicetelemetry.build_records())
        hub = TelemetryHub()
        sel = ks.KernelSelector("measured", hub, device="cpu")
        kernel = sel.choose("ksel-cache-op", "s", **KW)
        assert kernel in ("hash", "sort")
        builds.append(len(devicetelemetry.build_records()) - before)
        dev = hub.device.summary()
        assert dev["kselect"]["ksel-cache-op"]["hash_aggregate"][
            "launches"] == 1 + ks.PROBE_ITERS
        assert "ksel-cache-op" not in dev["kernels"]
        assert dev["totals"]["launches"] == 0
    assert builds == [0, 0]
    assert ck.LAUNCHES["hash_aggregate"] == 2 * (1 + ks.PROBE_ITERS)


def test_multiprocess_takes_static_path(monkeypatch):
    """A gang of ranks takes the static verdict, attributed as such."""
    sel = ks.KernelSelector("measured", None, device="cpu")
    monkeypatch.setattr(ks, "process_count", lambda: 2)
    assert sel.choose("ksel-mp-op", "s", **KW) == "hash"  # CPU static
    d = sel.stats.summary()["decisions"][0]
    assert d["reason"] == "static:multiprocess"
    assert "walls_ms" not in d
    monkeypatch.undo()
    assert ks.process_count() == 1  # no process group here


# ---------------------------------------------------- re-selection


def _fake_probe(monkeypatch):
    fake = {"winner": "hash", "walls_ms": {"hash": 1.0, "sort": 2.0}}
    monkeypatch.setattr(ks.KernelSelector, "_run_probe",
                        lambda self, *a, **k: dict(fake))
    monkeypatch.setattr(ref_ks.KernelSelector, "_run_probe",
                        lambda self, *a, **k: dict(fake))


def test_reselect_on_skew_shift(monkeypatch):
    """A RESELECT_RATIO shift of the op's per-partition rows drops the
    decision and its probe; the next consult decides again. The JAX
    package's selector, fed the same rows, agrees step by step."""
    _fake_probe(monkeypatch)
    port = ks.KernelSelector("measured", TelemetryHub(), device="cpu")
    ref = ref_ks.KernelSelector("measured", RefHub())
    steps = []
    for sel in (port, ref):
        hub = sel.hub
        trail = []
        hub.record_shuffle("op1", 1, [100, 100, 100, 100])
        kw = KW if sel is port else REF_KW
        trail.append(sel.choose("op1", "s", **kw))
        trail.append(sel.decision("op1", "s"))
        hub.record_shuffle("op1", 1, [10, 10, 10, 10])
        sel.observe_wave("op1")
        trail.append(sel.decision("op1", "s"))
        hub.record_shuffle("op1", 1, [900, 0, 0, 0])
        sel.observe_wave("op1")
        trail += [sel.decision("op1", "s"),
                  sel.stats.count("reselect", "measured:skew-shift")]
        trail += [sel.choose("op1", "s", **kw), sel.decision("op1", "s")]
        steps.append(trail)
    assert steps[0] == steps[1]
    assert steps[0] == ["hash", "hash", "hash", None, 1, "hash", "hash"]


def test_reselect_between_runs_of_one_op(monkeypatch):
    """A session's second run of the same op site with a different key
    profile re-selects once (its first run's decision had no profile
    yet, which is a shift too) and decides again at the next run."""
    _fake_probe(monkeypatch)
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "measured")
    sess = Session(executor=MeshExecutor(device="cpu", auto_dense=False))

    def run(keys):
        res = sess.run(_count_pipeline(bst, keys))
        assert dict(map(tuple, res.rows())) == _reduce_oracle(keys)
        return sess.kernel_select.stats.count("reselect",
                                              "measured:skew-shift")

    # Keys over 600 values: about 500 distinct a producer shard, which
    # K2's map-side regions hold without overflow (an overflow would
    # put the site on the sort path for good, out of the selector's
    # reach).
    rng = np.random.RandomState(3)
    wide = rng.randint(0, 600, 8000).astype(np.int32)
    hot = np.where(rng.rand(8000) < 0.9, 0,
                   rng.randint(0, 600, 8000)).astype(np.int32)
    first = run(wide)
    st = sess.kernel_select.stats
    n_decided = st.count("hash")
    second = run(hot)
    assert not sess.executor.hash_off
    assert second - first >= 1
    assert st.count("hash") > n_decided  # decided again in run 2
    third_before = st.count("hash")
    run(hot)
    assert st.count("hash") > third_before


def test_static_mode_never_reselects():
    sel = ks.KernelSelector("static", TelemetryHub(), device="cpu")
    sel.hub.record_shuffle("op1", 1, [1000, 0, 0, 0])
    sel.observe_wave("op1")  # no-op: nothing recorded, nothing raised
    assert sel.stats.samples == 0


# ------------------------------------- rendering: Prometheus + trace


def test_prometheus_families():
    """The kernel_select families' lines equal the JAX package's."""
    texts = []
    for sel_cls, hub, kw in ((lambda h: ks.KernelSelector(
            "static", h, device="cpu"), TelemetryHub(), KW),
                             (lambda h: ref_ks.KernelSelector("static", h),
                              RefHub(), REF_KW)):
        sel = sel_cls(hub)
        hub.kernel_select = sel.stats
        sel.choose("promop", "s", **kw)
        texts.append([ln for ln in hub.prometheus_text().splitlines()
                      if "bigslice_kernel_select" in ln
                      and not ln.startswith("# HELP")])
    assert texts[0] == texts[1]
    assert ('bigslice_kernel_select_mode{mode="static"} 1' in texts[0])
    assert ('bigslice_kernel_select_total{kernel="hash",'
            'reason="static:cpu-scatter-wins"} 1') in texts[0]


def test_slicetrace_renders_kernels_section(tmp_path, monkeypatch):
    """A real selection's bigslice:kernel_select instant carries the
    invocation and renders as an invN:kernels section offline."""
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "static")
    trace = tmp_path / "trace.json"
    keys = _sparse_keys()
    rows, sess = _port_run(keys, trace_path=str(trace))
    assert dict(rows) == _reduce_oracle(keys)
    assert sess.kernel_select.stats.samples >= 1
    sess.shutdown()  # writes the trace
    report = slicetrace.analyze(str(trace))
    assert ":kernels" in report
    assert "static:cpu-scatter-wins" in report


@pytest.mark.parametrize("prefetch", [1, 2])
def test_measured_probe_under_the_pipeline_and_the_skew_split(prefetch,
                                                               monkeypatch):
    """The probe runs where the wave program is built, on the group's
    thread, while the prefetcher stages the next waves and the skew
    policy splits a hot consumer wave into row slices: the run completes
    with the JAX package's rows, and the selector decided every
    boundary once."""
    rng = np.random.RandomState(7)
    keys = np.where(rng.rand(6000) < 0.7, 0,
                    rng.randint(0, 64, 6000)).astype(np.int32)
    ones = np.ones(len(keys), np.int32)

    def pipeline(mod):
        return mod.Reduce(mod.Map(mod.Reshuffle(mod.Const(8, keys, ones)),
                                  lambda k, v: (k, v + 0)),
                          lambda a, b: a + b)

    want = sorted(map(tuple, RefSession().run(pipeline(ref_bs)).rows()))
    monkeypatch.setenv("BIGSLICE_KERNEL_SELECT", "measured")
    monkeypatch.setenv("BIGSLICE_ADAPTIVE", "skew")
    sess = Session(executor=MeshExecutor(device="cpu", auto_dense=False,
                                         prefetch_depth=prefetch))
    got = sorted(map(tuple, sess.run(pipeline(bst)).rows()))
    assert got == want
    assert sess.adaptive.stats.skew_splits >= 1
    decided = [d for d in sess.kernel_select.stats.summary()["decisions"]
               if d["kernel"] != "reselect"]
    assert decided and all("walls_ms" in d for d in decided
                           if d["kernel"] == "hash")
    assert len({(d["op"], d["site"]) for d in decided}) == len(decided)
