"""The one-card tools (slicer, microbench, slicetypecheck) and the
staging breakdown against the JAX package.

Counterparts of ``tests/test_aux.py::test_slicetypecheck_tool``,
``::test_slicetypecheck_type_aware``, ``::test_slicer_tool`` and
``::test_microbench_tool``: the checker reports the same problem lines
as the JAX package's on the same source; every slicer mode runs at a
small size on the CPU (``-device cpu``), and where a mode returns a
value it equals the JAX package's on the same data; microbench prints
the JAX package's metric names. The staging breakdown: the telemetry
hub's ``staging_breakdown`` is filled on a reduce-wave with the parts
the JAX package fills, each within the staged seconds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bigslice_tpu as ref_bs  # noqa: E402
from bigslice_tpu.tools import slicer as ref_slicer  # noqa: E402
from bigslice_tpu.tools import slicetypecheck as ref_stc  # noqa: E402
import bigslice_tpu_torch as bst  # noqa: E402
from bigslice_tpu_torch.tools import microbench, slicer  # noqa: E402
from bigslice_tpu_torch.tools import slicetypecheck as stc  # noqa: E402

ARITY_SRC = (
    "import {pkg} as bs\n"
    "@bs.func\n"
    "def pipe(a, b, c=1):\n"
    "    return None\n"
    "sess.run(pipe, 1)\n"          # too few
    "sess.run(pipe, 1, 2)\n"       # ok
    "sess.run(pipe, 1, 2, 3)\n"    # ok
    "sess.run(pipe, 1, 2, 3, 4)\n"  # too many
)

TYPED_SRC = (
    "import {pkg} as bs\n"
    "@bs.func\n"
    "def pipe(n: int, name: str, rate: np.float32, free):\n"
    "    return None\n"
    "x = 'hello'\n"
    "sess.run(pipe, 4, 'corpus', 0.5, object())\n"   # ok
    "sess.run(pipe, 'four', 'corpus', 0.5, 1)\n"     # n: str
    "sess.run(pipe, 4, 7, 0.5, 1)\n"                 # name: int
    "sess.run(pipe, 4, x, 2, 1)\n"                   # ok (int->f32)
    "sess.run(pipe, 4, [1], 0.5, 1)\n"               # name: list
    "sess.run(pipe, dynamic_thing, 'c', 0.5, 1)\n"   # ok (dynamic)
    "sess.run(pipe, 4, 'c', 0.5, lambda: 1)\n"       # lambda
    "sess.run(pipe, 4, 'c', 0.5, open('f'))\n"       # file handle
    "sess.run(pipe, 4, 'c', 0.5, (i for i in x))\n"  # generator
)


def _lines(problems):
    return [p.split(":")[1] for p in problems]


def test_slicetypecheck_tool():
    problems = stc.check_source(ARITY_SRC.format(pkg="bigslice_tpu_torch"),
                                "x.py")
    want = ref_stc.check_source(ARITY_SRC.format(pkg="bigslice_tpu"),
                                "x.py")
    assert len(problems) == 2
    assert "x.py:5" in problems[0] and "x.py:8" in problems[1]
    assert problems == want


def test_slicetypecheck_type_aware():
    problems = stc.check_source(TYPED_SRC.format(pkg="bigslice_tpu_torch"),
                                "t.py")
    want = ref_stc.check_source(TYPED_SRC.format(pkg="bigslice_tpu"),
                                "t.py")
    lines = sorted(int(p.split(":")[1]) for p in problems)
    assert lines == [7, 8, 10, 12, 13, 14], problems
    assert _lines(problems) == _lines(want)
    joined = "\n".join(problems)
    for what in ("declares int", "declares str", "lambda", "file handle",
                 "generator"):
        assert what in joined


@pytest.mark.parametrize("decorator", ["@bs.func", "@func",
                                       "@bs.func(exclusive=True)"])
def test_slicetypecheck_cli_exit_codes(tmp_path, capsys, decorator):
    path = tmp_path / "p.py"
    path.write_text(f"import bigslice_tpu_torch as bs\n{decorator}\n"
                    f"def f(a):\n    return None\nsess.run(f)\n")
    assert stc.main([str(path)]) == 1
    assert f"{path}:5" in capsys.readouterr().out
    path.write_text("sess.run(f, 1)\n")
    assert stc.main([str(path)]) == 0
    assert stc.main([]) == 2


@pytest.mark.parametrize("mode", sorted(slicer.MODES))
def test_slicer_tool(capsys, mode):
    assert slicer.main([mode, "-rows", "2000", "-shards", "4",
                        "-device", "cpu"]) == 0
    assert f"slicer {mode}" in capsys.readouterr().out


def test_slicer_tool_local_executor(capsys):
    assert slicer.main(["-local", "reduce", "-rows", "2000", "-shards", "4",
                        "-device", "cpu"]) == 0
    assert "slicer reduce" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["reduce", "cogroup", "shuffle", "join",
                                  "waves"])
def test_slicer_scenarios_equal_the_jax_package(mode):
    """Each scenario's result on the port's device executor equals the
    JAX package's on its 8-device mesh, over the same data."""
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    rsess = Session(executor=MeshExecutor(
        Mesh(np.array(jax.devices()[:8]), ("shards",))))
    psess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    want = ref_slicer.MODES[mode](rsess, 3000, 4)
    got = slicer.MODES[mode](psess, 3000, 4)
    assert got == want
    psess.shutdown()
    rsess.shutdown()


def test_microbench_tool(capsys):
    microbench.bench_eval(20)
    microbench.bench_eval_fanout(4, 4)
    microbench.bench_frame(1 << 10, device="cpu")
    microbench.bench_codec(1 << 8)
    microbench.bench_device_reduce(1 << 10, device="cpu")
    microbench.bench_wave_stress(4, 256, device="cpu")
    out = capsys.readouterr().out
    names = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert names == {"eval_chain", "eval_fanout", "frame_hash",
                     "frame_partition", "frame_sort", "codec_encode",
                     "codec_decode", "device_reduce", "wave_stress"}


def test_staging_breakdown_is_filled_on_the_wave_path():
    """A reduce-wave with the hub on: the source group's waves carry the
    read/assemble/upload parts the JAX package's carry, each part
    non-negative and their sum within the staged seconds."""
    import jax
    from jax.sharding import Mesh

    from bigslice_tpu.exec.meshexec import MeshExecutor
    from bigslice_tpu.exec.session import Session

    keys = np.arange(4000, dtype=np.int32) % 37
    ones = np.ones(4000, np.int32)

    def staged(summary):
        return {op.split("@")[0]: o["waves"]
                for op, o in summary["ops"].items() if "waves" in o}

    psess = bst.Session(executor=bst.MeshExecutor(device="cpu"))
    psess.run(bst.Reduce(bst.Const(4, keys, ones), lambda a, b: a + b))
    got = staged(psess.telemetry_summary())
    psess.shutdown()
    rsess = Session(executor=MeshExecutor(
        Mesh(np.array(jax.devices()[:1]), ("shards",))))
    rsess.run(ref_bs.Reduce(ref_bs.Const(4, keys, ones), lambda a, b: a + b))
    want = staged(rsess.telemetry_summary())
    assert set(got) == set(want) == {"const", "reduce"}
    for op, w in got.items():
        parts = w.get("staging_breakdown", {})
        assert set(parts) == set(want[op].get("staging_breakdown", {}))
        assert all(v >= 0 for v in parts.values())
        assert sum(parts.values()) <= w["staging_s"] + 1e-6
    assert {"read_s", "assemble_s", "upload_s"} <= set(
        got["const"]["staging_breakdown"])
