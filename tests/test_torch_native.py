"""The host data plane of kge_tpu_torch (``kge_tpu_torch/native``, the
dataset's triple loader and the sampler's batch filter) against kge_tpu's
on the CPU: parses equal in value or in their ValueError, draws equal in
bits, with the library and with the numpy versions forced; and the build of
the library by several processes at once."""

import os
import subprocess
import sys

import numpy as np
import pytest

import kge_tpu.native as jnative
from kge_tpu.dataset import Dataset as JDataset
from kge_tpu_torch import native
from kge_tpu_torch.dataset import Dataset as TDataset
from kge_tpu_torch.indexing import KvsAllIndex, where_in

ROUTES = ["native", "numpy"]


@pytest.fixture(autouse=True)
def _libraries():
    if not jnative.available():
        pytest.fail("kge_tpu's native library did not build: it is the reference")
    assert native.available(), "the port's native library did not build"


def parse(route, path):
    """The port's parse by ``route``: the array, or the ValueError's text."""
    fn = native.parse_triples if route == "native" else native.parse_triples_numpy
    try:
        return fn(path).tolist()
    except ValueError as e:
        return str(e)


def reference(path):
    try:
        return jnative.parse_triples(path).tolist()
    except ValueError as e:
        return str(e)


PARSE_CASES = {
    "tab": b"0\t1\t2\n3\t4\t5\n",
    "space": b"0 1 2\n3  4   5\n",
    "crlf": b"0\t1\t2\r\n3\t4\t5\r\n",
    "extra_column": b"0\t1\t2\t7\n3\t4\t5 extra words\n6\t7\t8x\n",
    "negative_id": b"-1\t2\t-3\n4\t-5\t6\n1-2-3\n",
    "blank_lines": b"\n\n0\t1\t2\n\r\n\n3\t4\t5\n\n",
    "no_final_newline": b"0\t1\t2\n3\t4\t5",
    "leading_blanks": b"  0\t1\t2\n\t3 4 5\n",
    "wide_values": b"4294967297\t-4294967297\t2147483648\n",
    "empty_after_blank": b"\n\r\n",
    "short_line": b"0\t1\t2\n3\t4\n",
    "letters": b"0\t1\t2\n4\tx\t6\n",
    "spaces_only_line": b"0\t1\t2\n   \n3\t4\t5\n",
    "double_minus": b"0\t--1\t2\n",
    "glued_two_columns": b"12 3\n",
    "cr_inside": b"0\t1\r2\n",
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_triples_as_kge_tpu(tmp_path, case, route):
    """Equal arrays, or the same ValueError naming the same line."""
    path = str(tmp_path / f"{case}.del")
    with open(path, "wb") as f:
        f.write(PARSE_CASES[case])
    want = reference(path)
    got = parse(route, path)
    assert got == want
    if isinstance(want, list):
        assert native.parse_triples_numpy(path).dtype == np.int32


@pytest.mark.parametrize("seed", range(4))
def test_parse_triples_random_files_as_kge_tpu(tmp_path, seed):
    """Files of random characters of the grammar's alphabet, most of them
    malformed somewhere: both routes give kge_tpu's array or its error."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list(b"0123456789--  \t\t\r\n\n\nx"), dtype=np.uint8)
    path = str(tmp_path / "random.del")
    agreed_arrays = 0
    for _ in range(60):
        lines = []
        for _ in range(rng.integers(1, 6)):
            if rng.random() < 0.6:  # a line of the grammar, perturbed a little
                values = rng.integers(-999, 999, 3)
                seps = rng.choice([" ", "\t", "  ", " \t"], 3)
                line = "".join(f"{s}{v}" for s, v in zip(seps, values)).encode()
                if rng.random() < 0.3:
                    line += bytes(rng.choice(alphabet, rng.integers(1, 4)))
            else:
                line = bytes(rng.choice(alphabet, rng.integers(0, 12)))
            lines.append(line)
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))
        want = reference(path)
        agreed_arrays += isinstance(want, list)
        for route in ROUTES:
            assert parse(route, path) == want, (lines, route)
    assert agreed_arrays > 5


@pytest.mark.parametrize("route", ROUTES)
def test_parse_triples_large_file(tmp_path, route):
    rng = np.random.default_rng(1)
    triples = rng.integers(0, 100_000, (20_000, 3)).astype(np.int32)
    path = str(tmp_path / "train.del")
    np.savetxt(path, triples, fmt="%d", delimiter="\t")
    got = native.parse_triples(path) if route == "native" else \
        native.parse_triples_numpy(path)
    np.testing.assert_array_equal(got, jnative.parse_triples(path))
    np.testing.assert_array_equal(got, triples)


# the three files on which the loader of the port differed from kge_tpu's
LOADER_CASES = {
    "F1_spaces": b"0 1 2\n3 4 5\n",
    "F2_short_line": b"0\t1\t2\n3\t4\n",
    "F3_extra_text": b"0\t1\t2\n3\t4\t5 extra\n",
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_load_triples_file_as_kge_tpu(tmp_path, monkeypatch, case, route):
    """``Dataset._load_triples_file``: kge_tpu's value, or a ValueError
    where kge_tpu raises one, with the library and without it."""
    path = str(tmp_path / f"{case}.del")
    with open(path, "wb") as f:
        f.write(LOADER_CASES[case])
    try:
        want = JDataset._load_triples_file(path)
    except ValueError:
        want = None
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    calls = native.parse_triples.calls
    if want is None:
        with pytest.raises(ValueError, match="cannot parse triple file"):
            TDataset._load_triples_file(path)
    else:
        got = TDataset._load_triples_file(path)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert native.parse_triples.calls == calls + (route == "native")


def test_load_triples_file_other_delimiter(tmp_path):
    """Another delimiter splits each line and keeps three columns, as
    kge_tpu's pandas route does; a short line raises in both."""
    path = str(tmp_path / "comma.del")
    with open(path, "w") as f:
        f.write("1,2,3\n4,5,6\n\n7,8,9\n")
    np.testing.assert_array_equal(
        TDataset._load_triples_file(path, ","), JDataset._load_triples_file(path, ",")
    )
    with open(path, "w") as f:
        f.write("1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        JDataset._load_triples_file(path, ",")
    with pytest.raises(ValueError, match="line 2"):
        TDataset._load_triples_file(path, ",")


@pytest.mark.parametrize("not_in", [False, True])
def test_where_in_as_kge_tpu(not_in):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 50, 400)
    y = rng.integers(0, 50, 30)
    want = jnative.where_in(x, y, not_in=not_in)
    calls = native.where_in.calls
    np.testing.assert_array_equal(native.where_in(x, y, not_in=not_in), want)
    assert native.where_in.calls == calls + 1
    np.testing.assert_array_equal(where_in(x, y, not_in=not_in), want)


def csr_case(seed, vocab=40, rows=64, per_row=16):
    """A positives index (sp -> o) over random triples, a batch of its rows
    and uniform samples: ten (s, p) pairs with about 30 positives each (the
    C++ hashes more than 16) and many with a few (it scans them)."""
    rng = np.random.default_rng(seed)
    dense = np.stack([rng.integers(0, 5, 300), rng.integers(0, 2, 300),
                      rng.integers(0, vocab, 300)], axis=1)
    sparse = np.stack([rng.integers(5, 65, 300), rng.integers(0, 2, 300),
                       rng.integers(0, vocab, 300)], axis=1)
    triples = np.concatenate([dense, sparse]).astype(np.int32)
    index = KvsAllIndex(triples, [0, 1], 2)
    batch = triples[rng.permutation(len(triples))[:rows]]
    rows_idx = index.lookup_rows(batch[:, 0], batch[:, 1])
    rows_idx[::7] = -1  # some rows with no positives
    _, offsets, values = index.csr()
    samples = rng.integers(0, vocab, (rows, per_row)).astype(np.int64)
    counts = np.bincount(triples[:, 2], minlength=vocab) + 1.0
    return rows_idx, offsets, values, samples, np.cumsum(counts / counts.sum())


@pytest.mark.parametrize("vocab", [40, 400])
@pytest.mark.parametrize("use_cdf", [False, True])
def test_filter_resample_equal_in_bits(vocab, use_cdf):
    rows_idx, offsets, values, samples, cdf = csr_case(3, vocab=vocab)
    cdf = cdf if use_cdf else None
    sizes = np.diff(offsets)[rows_idx[rows_idx >= 0]]
    assert sizes.min() <= 16 < sizes.max()
    want, got = samples.copy(), samples.copy()
    replaced_want = jnative.filter_resample(want, rows_idx, offsets, values, vocab,
                                            seed=123456789, cdf=cdf)
    calls = native.filter_resample.calls
    replaced = native.filter_resample(got, rows_idx, offsets, values, vocab,
                                      seed=123456789, cdf=cdf)
    assert native.filter_resample.calls == calls + 1
    assert replaced == replaced_want > 0
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, samples)
    for i, r in enumerate(rows_idx):
        if r >= 0:
            assert not np.isin(got[i], values[offsets[r]:offsets[r + 1]]).any()
    # another seed draws otherwise
    other = samples.copy()
    native.filter_resample(other, rows_idx, offsets, values, vocab, seed=7, cdf=cdf)
    assert not np.array_equal(other, got)


def test_filter_resample_needs_contiguous_int64():
    rows_idx, offsets, values, samples, _ = csr_case(4)
    with pytest.raises(ValueError, match="int64"):
        native.filter_resample(samples.astype(np.int32), rows_idx, offsets, values,
                               40, seed=1)


@pytest.mark.parametrize("sampling_type", ["uniform", "frequency"])
@pytest.mark.parametrize("route", ROUTES)
def test_sampler_filter_draws_as_kge_tpu(monkeypatch, route, sampling_type):
    """The samplers' batch filter on the same seed and batch, the library on
    in both packages or off in both: equal samples, none a positive."""
    import kge_tpu
    import kge_tpu_torch
    from kge_tpu.ops.sampler import KgeSampler as JSampler
    from kge_tpu_torch.ops.sampler import KgeSampler as TSampler
    from tests.util import DATASET_DIR

    if route == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    samplers = []
    for package, sampler_class in ((kge_tpu, JSampler), (kge_tpu_torch, TSampler)):
        config = package.Config()
        config.set("console.quiet", True)
        config.set("dataset.name", "dataset_test")
        config.set("negative_sampling.sampling_type", sampling_type)
        config.set("negative_sampling.num_samples.s", 5)
        config.set("negative_sampling.num_samples.o", 5)
        config.set("negative_sampling.filtering.s", True)
        config.set("negative_sampling.filtering.o", True)
        config.set("negative_sampling.filtering.implementation", "fast")
        dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
        sampler = sampler_class.create(config, "negative_sampling", dataset)
        sampler.seed(11)
        samplers.append((sampler, dataset.split("train").astype(np.int64)))
    calls = native.filter_resample.calls
    for slot in (0, 2):
        for _ in range(3):
            (jsampler, triples), (tsampler, _) = samplers
            want = jsampler.sample(triples, slot).samples
            got = tsampler.sample(triples, slot).samples
            np.testing.assert_array_equal(got, want)
            rows_idx, offsets, values = tsampler._positives_csr(slot, triples)
            for i, r in enumerate(rows_idx):
                if r >= 0:
                    assert not np.isin(got[i], values[offsets[r]:offsets[r + 1]]).any()
    assert native.filter_resample.calls == calls + (6 if route == "native" else 0)


BUILD = """
import sys
from kge_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
assert native.available()
print(native.library_path())
"""


def test_two_processes_build_into_one_directory(tmp_path):
    """Two processes build the library into an empty directory at once:
    both load it, and one library is left, with no temporary file."""
    build_dir = str(tmp_path / "native")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, build_dir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(build_dir) == [os.path.basename(paths.pop())]


def test_failed_build_returns_none_and_says_why(tmp_path, monkeypatch, capsys):
    """A source g++ refuses: every entry point returns None, the compiler's
    output goes to stderr once, and the callers take the numpy versions."""
    bad = tmp_path / "kge_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    assert not native.available()
    assert "g++ failed" in capsys.readouterr().err
    path = tmp_path / "t.del"
    path.write_text("0 1 2\n")
    assert native.parse_triples(str(path)) is None
    assert native.where_in(np.arange(3), np.arange(2)) is None
    assert native.filter_resample(np.zeros((1, 1), np.int64), np.zeros(1, np.int64),
                                  np.zeros(2, np.int64), np.zeros(0, np.int32), 3,
                                  seed=0) is None
    assert capsys.readouterr().err == ""
    np.testing.assert_array_equal(TDataset._load_triples_file(str(path)), [[0, 1, 2]])
    assert os.listdir(tmp_path / "build") == []
