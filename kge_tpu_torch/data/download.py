"""Dataset downloader.

Fetches the standard benchmark datasets in preprocessed ``.del`` form from
their public locations (the same archives the reference's
data/download_all.sh uses) into a local ``data/`` directory. Datasets that
ship raw can be converted with ``kge_tpu_torch.data.preprocess``. The
package's own copy of ``kge_tpu/data/download.py``.

Usage: ``python -m kge_tpu_torch.data.download [dataset ...]`` (no
arguments: download everything).
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import urllib.request

_BASE = "https://web.informatik.uni-mannheim.de/pi1/kge-datasets"

DATASETS = {
    name: f"{_BASE}/{name}.tar.gz"
    for name in [
        "toy", "fb15k", "fb15k-237", "wn18", "wnrr", "wn11",
        "dbpedia50", "dbpedia500", "db100k", "yago3-10", "wikidata5m",
        "kinship", "nations", "umls",
    ]
}
DATASETS.update({
    f"codex-{size}":
        f"https://zenodo.org/record/4281094/files/codex-{size}.tar.gz?download=1"
    for size in ("s", "m", "l")
})


def download(name: str, data_dir: str = "data") -> str:
    if name not in DATASETS:
        raise ValueError(
            f"unknown dataset {name}; available: {sorted(DATASETS)}"
        )
    target = os.path.join(data_dir, name)
    if os.path.isfile(os.path.join(target, "dataset.yaml")):
        print(f"{name}: already present at {target}")
        return target
    os.makedirs(data_dir, exist_ok=True)
    archive = os.path.join(data_dir, f"{name}.tar.gz")
    url = DATASETS[name]
    print(f"{name}: downloading {url} ...")
    urllib.request.urlretrieve(url, archive)
    print(f"{name}: extracting ...")
    with tarfile.open(archive, "r:gz") as tar:
        # "fully_trusted" extracts what tarfile has always extracted; naming
        # it keeps Python 3.12 from warning that the default will change
        tar.extractall(data_dir, filter="fully_trusted")
    os.remove(archive)
    return target


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("datasets", nargs="*", default=[],
                        help="dataset names (default: all)")
    parser.add_argument("--data-dir", default="data")
    args = parser.parse_args()
    names = args.datasets or sorted(DATASETS)
    failures = []
    for name in names:
        try:
            download(name, args.data_dir)
        except Exception as e:
            print(f"{name}: FAILED ({e})", file=sys.stderr)
            failures.append(name)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
