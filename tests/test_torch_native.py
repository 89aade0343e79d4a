"""The port's native host kernels and string parse against the JAX
package's.

Each case of tests/test_native.py has its counterpart here: the same
corpora (imported from it) and seeded inputs go through the JAX
package's ``native`` and ``strparse`` and the port's, and the codes,
vocabularies and CRCs must be equal, exactly, with the kernels built and
with ``BIGSLICE_NATIVE=0``. Beside them: where the port's builds land,
the rung counters, and ``hash_host_column`` against the JAX package's.
"""

import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu import native as ref_native  # noqa: E402
from bigslice_tpu.frame import ops as ref_ops  # noqa: E402
from bigslice_tpu.frame import strparse as ref_strparse  # noqa: E402
from bigslice_tpu.frame.dictenc import GlobalVocab as RefVocab  # noqa: E402
from test_native import CORPORA  # noqa: E402

from bigslice_tpu_torch import native  # noqa: E402
from bigslice_tpu_torch.frame import ops as frame_ops  # noqa: E402
from bigslice_tpu_torch.frame import strparse  # noqa: E402
from bigslice_tpu_torch.frame.dictenc import GlobalVocab  # noqa: E402
from bigslice_tpu_torch.frame.frame import obj_col  # noqa: E402
from bigslice_tpu_torch.models.urls import _domain  # noqa: E402


def _domains(codes, vocab):
    return vocab.decode(codes).tolist()


def _joined(lines):
    return "\n".join(lines).encode("utf-8") + b"\n"


@pytest.fixture
def built():
    """The port's native kernels, built (this host has cc and
    Python.h)."""
    assert native.rungs() == {"strscan": True, "strlist": True}
    return native


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_native_matches_oracle_and_jax(built, name):
    lines = CORPORA[name]
    codes, uniques = native.domains_encode(_joined(lines), len(lines))
    for i, line in enumerate(lines):
        want = _domain(line)
        if codes[i] < 0:
            # Quarantined rows are exactly the non-ASCII-domain ones.
            assert not want.isascii(), (line, want)
        else:
            assert uniques[codes[i]] == want, (line, want)
    ref_codes, ref_uniques = ref_native.domains_encode(_joined(lines),
                                                       len(lines))
    np.testing.assert_array_equal(codes, ref_codes)
    assert uniques == ref_uniques
    lcodes, luniques = native.domains_encode_list(lines)
    rcodes, runiques = ref_native.domains_encode_list(lines)
    np.testing.assert_array_equal(lcodes, rcodes)
    assert luniques == runiques


def test_native_dedups_codes(built):
    lines = ["http://a.com/%d" % (i % 7) for i in range(500)]
    codes, uniques = native.domains_encode(_joined(lines), len(lines))
    assert uniques == ["a.com"]
    np.testing.assert_array_equal(codes, np.zeros(500, np.int32))


def test_native_rejects_embedded_newline(built):
    assert native.domains_encode(b"a\nb\n\n", 2) is None  # 3 rows framed
    # The list kernel has no framing: the newline stays in its row.
    codes, uniques = native.domains_encode_list(["a\nb", "c"])
    assert [uniques[c] for c in codes] == [_domain("a\nb"), "c"]


def _lines(seed=5, n=4000):
    rng = np.random.RandomState(seed)
    lines = [f"http://Site{rng.randint(0, 97)}.Example.com/p/{i}"
             for i in range(n)]
    lines[17] = "http://ünï.code/x"
    lines[801] = "plain token"
    lines[802] = ""
    return lines


def test_domains_codes_native_vs_disabled(monkeypatch):
    """The whole parse is bit-identical with the native rung on and off
    (the off path is the Arrow chain)."""
    lines = _lines()
    v1 = GlobalVocab()
    c1 = strparse.domains_codes(lines, v1)
    monkeypatch.setenv("BIGSLICE_NATIVE", "0")
    v2 = GlobalVocab()
    c2 = strparse.domains_codes(lines, v2)
    assert _domains(c1, v1) == _domains(c2, v2)
    assert _domains(c1, v1) == [_domain(u) for u in lines]


@pytest.mark.parametrize("native_on", ["1", "0"])
def test_codes_and_vocab_equal_jax(monkeypatch, native_on):
    """``domains_codes`` gives the JAX package's codes and vocabulary on
    the same lines, natively and with the fallbacks forced."""
    monkeypatch.setenv("BIGSLICE_NATIVE", native_on)
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "0")
    lines = _lines(seed=11)
    v, rv = GlobalVocab(), RefVocab()
    for lo, hi in ((0, 1500), (1500, 4000)):  # the vocabulary grows
        np.testing.assert_array_equal(
            strparse.domains_codes(lines[lo:hi], v),
            ref_strparse.domains_codes(lines[lo:hi], rv))
    assert v.decode(np.arange(len(v))).tolist() == \
        rv.decode(np.arange(len(rv))).tolist()


def test_rungs_are_counted(monkeypatch):
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "0")
    strparse.reset_rungs()
    native.reset_calls()
    lines = _lines(n=900)
    strparse.domains_codes(lines, GlobalVocab())
    assert strparse.RUNGS["native-list"] == 1
    assert native.CALLS["domains_encode_list"] == 1
    monkeypatch.setenv("BIGSLICE_NATIVE", "0")
    strparse.domains_codes(lines, GlobalVocab())
    assert strparse.RUNGS["arrow"] == 1
    strparse.domains_codes([1, 2], GlobalVocab(), fallback_fn=str)
    assert strparse.RUNGS["python"] == 1
    assert native.CALLS["domains_encode_list"] == 1


def test_ctypes_rung_when_the_extension_is_missing(monkeypatch):
    """Without the extension (no Python.h) the ctypes kernel over a
    joined buffer answers, with the same codes."""
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "0")
    lines = _lines(seed=2, n=1000)
    v1 = GlobalVocab()
    c1 = strparse.domains_codes(lines, v1)
    monkeypatch.setattr(native, "_load_list", lambda: None)
    strparse.reset_rungs()
    v2 = GlobalVocab()
    c2 = strparse.domains_codes(lines, v2)
    assert strparse.RUNGS["native-buffer"] == 1
    assert _domains(c1, v1) == _domains(c2, v2)
    assert native.crc32_strings(["a"]) is None


def test_pool_path_native_workers(monkeypatch):
    """The process pool's parse rides the native kernel inside each
    worker and stays exact, unicode rows included."""
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "2")
    strparse.shutdown_pool()
    strparse.reset_rungs()
    try:
        lines = [f"http://Pool{i % 13}.org/x/{i}" for i in range(1024)]
        lines[100] = "http://ünï.code/x"
        lines[500] = "bare token"
        v = GlobalVocab()
        codes = strparse.domains_codes(lines, v, _domain, chunk_rows=256)
        assert _domains(codes, v) == [_domain(u) for u in lines]
        assert strparse.RUNGS["native-buffer"] == 4  # one a chunk
        rv = RefVocab()
        ref = ref_strparse.domains_codes(lines, rv, chunk_rows=256)
        np.testing.assert_array_equal(codes, ref)
    finally:
        strparse.shutdown_pool()
        ref_strparse.shutdown_pool()


def test_fuzz_native_oracle():
    rng = np.random.RandomState(9)
    alphabet = list("abXY9./:éß ")
    for _ in range(30):
        lines = ["".join(rng.choice(alphabet, rng.randint(0, 25)).tolist())
                 for _ in range(rng.randint(1, 40))]
        v = GlobalVocab()
        codes = strparse.domains_codes_single(lines, v, _domain)
        assert _domains(codes, v) == [_domain(u) for u in lines]


def test_crc32_strings_matches_python_and_jax(built):
    """The native CRC is bit-identical to the per-row CRC of str
    columns; non-str and surrogate elements are refused (None)."""
    lines = ["", "a", "hello world", "Ünïcode-ok", "x" * 500]
    h = native.crc32_strings(lines)
    want = [zlib.crc32(s.encode("utf-8", "surrogatepass")) for s in lines]
    assert h.tolist() == want
    np.testing.assert_array_equal(h, ref_native.crc32_strings(lines))
    assert native.crc32_strings(["ok", 7]) is None
    assert native.crc32_strings(["lone\udc80surrogate"]) is None


def test_hash_host_column_native_parity(monkeypatch):
    native.reset_calls()
    col = obj_col([f"key{i}" for i in range(500)] + ["Ünï"])
    h1 = frame_ops.hash_host_column(col, seed=3)
    assert native.CALLS["crc32_strings"] == 1
    np.testing.assert_array_equal(h1, ref_ops.hash_host_column(col, seed=3))
    monkeypatch.setenv("BIGSLICE_NATIVE", "0")
    h2 = frame_ops.hash_host_column(col, seed=3)
    np.testing.assert_array_equal(h1, h2)
    # A mixed column (ints take the per-row path) agrees too.
    mixed = obj_col(["a", 5, "b"])
    h3 = frame_ops.hash_host_column(mixed, seed=1)
    monkeypatch.setenv("BIGSLICE_NATIVE", "1")
    np.testing.assert_array_equal(frame_ops.hash_host_column(mixed, seed=1),
                                  h3)
    np.testing.assert_array_equal(h3, ref_ops.hash_host_column(mixed, seed=1))
    assert native.CALLS["crc32_strings"] == 1


def test_surrogate_column_falls_back_to_the_row_path():
    col = obj_col(["a", "lone\udc80", "b"])
    np.testing.assert_array_equal(frame_ops.hash_host_column(col, 2),
                                  ref_ops.hash_host_column(col, 2))


def test_builds_land_in_the_build_directory(built):
    """Each .so is built under bigslice_tpu_torch/_build/, named by a
    digest of its source, never beside the source."""
    so_files = sorted(f for f in os.listdir(native.BUILD_DIR)
                      if f.startswith("native-") and f.endswith(".so"))
    stems = {f.split("-")[1] for f in so_files}
    assert {"strscan", "strlist"} <= stems
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]
    assert native._so_path(native._SRC, (), "") == native._so_path(
        native._SRC, (), "")
    assert native._so_path(native._SRC, (), "") != native._so_path(
        native._SRC, ("-g",), "")


def test_disabled_native_returns_none(monkeypatch):
    monkeypatch.setenv("BIGSLICE_NATIVE", "0")
    assert native.domains_encode(b"a\n", 1) is None
    assert native.domains_encode_list(["a"]) is None
    assert native.crc32_strings(["a"]) is None
