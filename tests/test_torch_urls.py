"""The port's urls model (the domain count) against the JAX package's.

The cases of tests/test_models.py on ``models/urls.py`` and
``frame/strparse.py`` have their counterparts here. ``domain_count``
and ``domain_count_encoded`` run on the port's ``MeshExecutor(device=
"cpu")`` and ``LocalExecutor(device="cpu")`` and must give the JAX
package's rows on its ``MeshExecutor`` (a one-device mesh, so every
lowering decision matches) and its ``LocalExecutor``, exactly.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import bigslice_tpu.models.urls as ref_urls  # noqa: E402
from bigslice_tpu.exec.session import Session as RefSession  # noqa: E402
from bigslice_tpu.frame import dictenc as ref_dictenc  # noqa: E402
from bigslice_tpu.frame import strparse as ref_strparse  # noqa: E402

import bigslice_tpu_torch as bst  # noqa: E402
import bigslice_tpu_torch.models.urls as urls  # noqa: E402
from bigslice_tpu_torch import slicetest  # noqa: E402
from bigslice_tpu_torch.frame import dictenc, strparse  # noqa: E402


@pytest.fixture(scope="module")
def mesh1():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("shards",))


def _port_session(kind):
    if kind == "mesh":
        return bst.Session(executor=bst.MeshExecutor(device="cpu"))
    return bst.Session(executor=bst.LocalExecutor(device="cpu"))


def _ref_session(kind, mesh1):
    if kind == "mesh":
        from bigslice_tpu.exec.meshexec import MeshExecutor

        return RefSession(executor=MeshExecutor(mesh1))
    return RefSession()


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_urls_domain_count(tmp_path, kind):
    p = tmp_path / "urls.txt"
    p.write_text("http://a.com/x\nhttps://b.org/y\nhttp://A.com/z\n"
                 "https://b.org/\nhttp://c.net\n")
    got = dict(slicetest.scan_all(urls.domain_count(3, str(p)),
                                  session=_port_session(kind)))
    assert got == {"a.com": 2, "b.org": 2, "c.net": 1}


def test_domains_batch_matches_scalar():
    cases = [
        "http://A.com/x/y", "https://b.org/", "c.net", "c.net/",
        "HTTP://UPPER.COM", "ftp://f.io/a//b", "//bare.host/p",
        "no-scheme/with/path", "", "http://", "a//b/c",
    ]
    got = urls._domains_batch(cases).tolist()
    assert got == [urls._domain(u) for u in cases]
    assert got == ref_urls._domains_batch(cases).tolist()
    assert urls._domains_batch([]).tolist() == []


def test_strparse_domains_codes_matches_scalar():
    """The vectorized parse is bit-equal to ``_domain`` on every shape
    (schemes, missing schemes, several '//', case, unicode rows, an
    embedded newline, fuzz) and gives the JAX package's codes."""
    cases = [
        "http://A.com/x/y", "https://b.org/", "c.net", "c.net/",
        "HTTP://UPPER.COM", "ftp://f.io/a//b", "//bare.host/p",
        "no-scheme/with/path", "", "http://", "a//b/c", "/", "//",
        "///", "x//", "a//host", "Ünïcode://CASÉ/p", "ÅÄÖ",
        "http://ÅÄÖ.se/path", "a//bß/c", "we\nird//x/y",
    ]
    vocab = dictenc.GlobalVocab()
    codes = strparse.domains_codes(cases, vocab)
    assert list(vocab.decode(codes)) == [urls._domain(u) for u in cases]
    np.testing.assert_array_equal(
        codes, ref_strparse.domains_codes(cases, ref_dictenc.GlobalVocab()))
    rng = random.Random(7)
    alpha = "aB/:.xÅé \t"
    fuzz = ["".join(rng.choice(alpha) for _ in range(rng.randint(0, 12)))
            for _ in range(2000)]
    v2 = dictenc.GlobalVocab()
    assert list(v2.decode(strparse.domains_codes(fuzz, v2))) == [
        urls._domain(u) for u in fuzz]
    assert strparse.domains_codes([], dictenc.GlobalVocab()).tolist() == []


def test_strparse_pool_path_matches(monkeypatch):
    """The pool's chunked parse agrees with the single-process path (two
    workers forced, small chunks), a non-ASCII row fixed up inside a
    chunk."""
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "2")
    strparse.shutdown_pool()
    try:
        lines = [f"http://S{i % 97}.example.com/p{i}" for i in range(4096)]
        lines[17] = "Ünïcode://CASÉ/p"
        vocab = dictenc.GlobalVocab()
        codes = strparse.domains_codes(lines, vocab, chunk_rows=1024)
        assert list(vocab.decode(codes)) == [urls._domain(u) for u in lines]
        monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "0")
        single = dictenc.GlobalVocab()
        np.testing.assert_array_equal(
            codes, strparse.domains_codes(lines, single))
    finally:
        strparse.shutdown_pool()


def _corpus(tmp_path, n=2000, seed=3):
    """A seeded URL corpus in the shape of the JAX package's urls
    benchmark (Zipf domains), with mixed case and a non-ASCII row."""
    rng = np.random.RandomState(seed)
    d = rng.zipf(1.5, n) % 60
    lines = [f"http://Site{int(x)}.Example.com/p/{i & 1023}"
             for i, x in enumerate(d)]
    lines[5] = "http://Ünï.example/x"
    p = tmp_path / "urls.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p), lines


@pytest.mark.parametrize("kind", ["mesh", "local"])
def test_urls_domain_count_encoded_matches_jax(tmp_path, mesh1, kind):
    path, lines = _corpus(tmp_path)
    want = {}
    for u in lines:
        want[urls._domain(u)] = want.get(urls._domain(u), 0) + 1
    sess = _port_session(kind)
    rows = urls.domain_count_encoded(sess, 4, path)
    assert dict(rows) == want and len(rows) == len(want)
    ref_rows = ref_urls.domain_count_encoded(_ref_session(kind, mesh1), 4,
                                             path)
    assert sorted(rows) == sorted(ref_rows)
    # The host str-key count agrees, and with the JAX package's.
    host = sorted(_port_session(kind).run(urls.domain_count(4, path)).rows())
    assert host == sorted(rows)
    ref_host = _ref_session(kind, mesh1).run(ref_urls.domain_count(4, path))
    assert host == sorted(ref_host.rows())


def test_attach_one_is_a_device_map():
    """The encoded count's unit-count Map traces as a device function
    (a literal 1 would send it to the host tier, a Python call a row)."""
    m = bst.Map(bst.Const(1, np.arange(4, dtype=np.int32)), urls._attach_one,
                out=[np.int32, np.int32])
    assert m.mode == "device"
    assert [c.dtype for c in m.schema] == [np.dtype(np.int32)] * 2


def test_urls_domain_count_encoded(tmp_path):
    p = tmp_path / "urls.txt"
    lines = [f"http://site{i % 7}.com/page{i}" for i in range(200)]
    p.write_text("\n".join(lines) + "\n")
    rows = urls.domain_count_encoded(_port_session("mesh"), 4, str(p))
    assert dict(rows) == {f"site{d}.com": len(range(d, 200, 7))
                          for d in range(7)}


def test_domain_count_encoded_over_a_sequence_with_the_pool(monkeypatch):
    """A list source (random-access striping) through the pool: the
    encoded Reduce runs on the device path (no retraction) and equals
    the host count."""
    monkeypatch.setenv("BIGSLICE_PARSE_PROCS", "2")
    strparse.shutdown_pool()
    try:
        rng = np.random.RandomState(8)
        lines = [f"http://s{int(x)}.example.com/p/{i}"
                 for i, x in enumerate(rng.zipf(1.5, 1 << 16) % 500)]
        sess = _port_session("mesh")
        strparse.reset_rungs()
        rows = urls.domain_count_encoded(sess, 2, lines)
        assert strparse.RUNGS["native-buffer"] > 0  # the pool's workers
        want = {}
        for u in lines:
            want[urls._domain(u)] = want.get(urls._domain(u), 0) + 1
        assert dict(rows) == want
        assert not sess.executor.auto_dense_off
    finally:
        strparse.shutdown_pool()
