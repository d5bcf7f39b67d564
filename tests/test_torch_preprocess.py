"""Data preparation of kge_tpu_torch (``data/preprocess.py``,
``data/download.py`` and ``dataset.from_dir`` on raw splits) against
kge_tpu's on the CPU: every written file equal in bytes, the same ``info``,
the same command line output, the same splits and maps after an ingest, and
the same extracted trees from a local tarball."""

import filecmp
import hashlib
import os
import shutil
import subprocess
import sys
import tarfile

import numpy as np
import pytest

import kge_tpu
import kge_tpu_torch
from kge_tpu.data import download as jdownload
from kge_tpu.data import preprocess as jpreprocess
from kge_tpu_torch.data import download as tdownload
from kge_tpu_torch.data import preprocess as tpreprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_raw(folder, seed, *, order_sop=False, labeled=False, unseen=False,
              duplicates=False, names="ascii", num_entities=30, num_relations=5,
              sizes=(120, 20, 20)):
    """Raw train/valid/test.txt splits of random triples over named entities
    and relations, made from ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    if names == "ascii":
        entities = [f"/m/0{rng.integers(36**4):x}_{i}" for i in range(num_entities)]
        relations = [f"/film/rel_{i}/path" for i in range(num_relations)]
    else:
        entities = [f"Entität_{i}_ß→{chr(0x4e00 + i)}" for i in range(num_entities)]
        relations = [f"связь_{i}" for i in range(num_relations)]
    # entities and relations seen only outside train, where asked
    train_entities = num_entities - 3 if unseen else num_entities
    train_relations = num_relations - 1 if unseen else num_relations
    for split, size in zip(("train", "valid", "test"), sizes):
        ents = train_entities if split == "train" else num_entities
        rels = train_relations if split == "train" else num_relations
        s = rng.integers(0, ents, size)
        p = rng.integers(0, rels, size)
        o = rng.integers(0, ents, size)
        lines = []
        for i in range(size):
            fields = [entities[s[i]], relations[p[i]], entities[o[i]]]
            if order_sop:
                fields = [fields[0], fields[2], fields[1]]
            if labeled and split != "train":
                fields.append(str(rng.choice([1, -1])))
            lines.append("\t".join(fields))
        if duplicates:
            lines += [lines[i] for i in rng.integers(0, size, size // 4)]
        with open(os.path.join(folder, f"{split}.txt"), "w", encoding="utf-8") as f:
            f.write("".join(line + "\n" for line in lines))


RAW_CASES = {
    "default": {},
    "order_sop": {"order_sop": True},
    "labeled": {"labeled": True},
    "unseen": {"unseen": True},
    "duplicates": {"duplicates": True},
    "non_ascii": {"names": "non_ascii"},
}


def assert_same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_preprocess_default_writes_kge_tpu_files(tmp_path, case):
    options = RAW_CASES[case]
    jdir, tdir = str(tmp_path / "j" / "ds"), str(tmp_path / "t" / "ds")
    write_raw(jdir, seed=len(case), **options)
    shutil.copytree(jdir, tdir)
    flags = {k: v for k, v in options.items() if k in ("order_sop", "labeled")}
    want = jpreprocess.preprocess_default(jdir, **flags)
    got = tpreprocess.preprocess_default(tdir, **flags)
    assert got == want
    assert_same_tree(jdir, tdir)
    files = set(os.listdir(tdir))
    assert {"train.del", "valid.del", "test.del", "train_sample.del",
            "valid_without_unseen.del", "test_without_unseen.del",
            "entity_ids.del", "relation_ids.del", "dataset.yaml"} <= files
    if case == "labeled":
        assert {"valid_labels.del", "test_labels.del"} <= files
    if case == "unseen":
        for split in ("valid", "test"):
            assert (got["files"][f"{split}_without_unseen"]["size"]
                    < got["files"][split]["size"])


def test_preprocess_command_prints_kge_tpu_line(tmp_path):
    folder = str(tmp_path / "cli_ds")
    write_raw(folder, seed=5, labeled=True)
    outputs = []
    for package in ("kge_tpu", "kge_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{package}.data.preprocess", folder, "--labeled"],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert proc.returncode == 0, proc.stderr
        outputs.append(proc.stdout)
        with open(os.path.join(folder, "dataset.yaml"), "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[2] and outputs[1] == outputs[3]
    assert outputs[2].startswith(f"Preprocessed {folder}: 30 entities, 5 relations")


def create(package, folder, name, checksum=None):
    config = package.Config()
    config.set("console.quiet", True)
    config.set("dataset.name", name)
    config.set("dataset.from_dir", folder)
    if checksum is not None:
        config.set("dataset.from_dir_checksum", checksum)
    return package.Dataset.create(config)


def raw_digest(folder):
    h = hashlib.sha256()
    for name in ("train.txt", "valid.txt", "test.txt"):
        with open(os.path.join(folder, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def assert_same_dataset(jds, tds):
    assert tds.num_entities() == jds.num_entities()
    assert tds.num_relations() == jds.num_relations()
    for split in ("train", "valid", "test", "train_sample",
                  "valid_without_unseen", "test_without_unseen"):
        np.testing.assert_array_equal(tds.split(split), jds.split(split))
    assert tds.entity_ids() == jds.entity_ids()
    assert tds.relation_ids() == jds.relation_ids()


@pytest.mark.parametrize("checksum", [False, True])
def test_from_dir_ingests_raw_splits_as_kge_tpu(tmp_path, checksum):
    """``dataset.from_dir`` on raw splits preprocesses them in place, with or
    without a checksum, into kge_tpu's files, splits and maps; a wrong
    checksum fails before any use; the prepared folder loads directly."""
    jdir, tdir = str(tmp_path / "j" / "rawset"), str(tmp_path / "t" / "rawset")
    write_raw(jdir, seed=7, unseen=True)
    shutil.copytree(jdir, tdir)
    digest = raw_digest(tdir) if checksum else None
    jds = create(kge_tpu, jdir, "rawset", digest)
    tds = create(kge_tpu_torch, tdir, "rawset", digest)
    assert_same_dataset(jds, tds)
    assert os.path.isfile(os.path.join(tdir, ".from_dir_verified")) == checksum
    for name in os.listdir(jdir):
        if not name.endswith(".kgecache"):
            assert filecmp.cmp(os.path.join(jdir, name), os.path.join(tdir, name),
                               shallow=False), name

    with pytest.raises(ValueError, match="checksum"):
        create(kge_tpu_torch, tdir, "rawset", "0" * 64)
    again = create(kge_tpu_torch, tdir, "rawset")
    assert_same_dataset(jds, again)


def test_from_dir_checksum_after_raw_removal_as_kge_tpu(tmp_path):
    """A folder verified at its ingest keeps loading once its raw splits
    are gone; a folder with neither raw splits nor a stamp fails."""
    jdir, tdir = str(tmp_path / "j" / "rawset2"), str(tmp_path / "t" / "rawset2")
    write_raw(jdir, seed=8)
    shutil.copytree(jdir, tdir)
    digest = raw_digest(tdir)
    create(kge_tpu, jdir, "rawset2", digest)
    create(kge_tpu_torch, tdir, "rawset2", digest)
    for folder in (jdir, tdir):
        for name in ("train.txt", "valid.txt", "test.txt"):
            os.remove(os.path.join(folder, name))
    assert_same_dataset(create(kge_tpu, jdir, "rawset2", digest),
                        create(kge_tpu_torch, tdir, "rawset2", digest))

    empty = tmp_path / "nothing"
    empty.mkdir()
    with pytest.raises(IOError, match="missing"):
        create(kge_tpu_torch, str(empty), "nothing", digest)
    with pytest.raises(IOError, match="neither"):
        create(kge_tpu_torch, str(empty), "nothing")


@pytest.fixture()
def served_tarball(tmp_path, monkeypatch):
    """A prepared dataset packed as ``toyds.tar.gz`` and both packages'
    ``DATASETS`` pointing at it by a ``file://`` URL."""
    source = tmp_path / "source"
    folder = source / "toyds"
    write_raw(str(folder), seed=9)
    tpreprocess.preprocess_default(str(folder))
    archive = tmp_path / "toyds.tar.gz"
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(folder, arcname="toyds")
    url = archive.as_uri()
    for module in (jdownload, tdownload):
        monkeypatch.setitem(module.DATASETS, "toyds", url)
    return folder, url


def test_download_extracts_kge_tpu_tree(tmp_path, served_tarball, capsys):
    folder, url = served_tarball
    trees = []
    for label, module in (("j", jdownload), ("t", tdownload)):
        data_dir = str(tmp_path / label / "data")
        target = module.download("toyds", data_dir)
        assert target == os.path.join(data_dir, "toyds")
        trees.append(target)
        out = capsys.readouterr().out
        assert out == (f"toyds: downloading {url} ...\ntoyds: extracting ...\n")
        assert os.listdir(data_dir) == ["toyds"]  # the archive is removed
    assert_same_tree(trees[0], trees[1])
    assert_same_tree(str(folder), trees[1])

    # already present: nothing fetched
    for module, target in zip((jdownload, tdownload), trees):
        assert module.download("toyds", os.path.dirname(target)) == target
        assert capsys.readouterr().out == f"toyds: already present at {target}\n"


def test_download_unknown_name_and_exit_codes(tmp_path, served_tarball, monkeypatch,
                                              capsys):
    messages = []
    for module in (jdownload, tdownload):
        with pytest.raises(ValueError) as e:
            module.download("no-such-dataset", str(tmp_path))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert messages[1].startswith("unknown dataset no-such-dataset; available:")

    for label, module in (("j", jdownload), ("t", tdownload)):
        data_dir = str(tmp_path / label)
        monkeypatch.setattr(sys, "argv", ["download", "toyds", "--data-dir", data_dir])
        module.main()  # no exit on success
        assert os.path.isfile(os.path.join(data_dir, "toyds", "dataset.yaml"))
        monkeypatch.setattr(sys, "argv", ["download", "toyds", "no-such-dataset",
                                          "--data-dir", data_dir])
        with pytest.raises(SystemExit) as e:
            module.main()
        assert e.value.code == 1
        assert "no-such-dataset: FAILED (unknown dataset" in capsys.readouterr().err
