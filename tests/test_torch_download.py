"""Port: the download CLI (``points2surf_tpu_torch/cli/download.py``), with no
network: pre-staged zips (``--from_local_zip``, as ``tests/test_io.py``
holds the JAX package's) and ``download_and_unzip`` through ``file://``
URLs to zips the test builds."""

import io
import zipfile

import numpy as np

from points2surf_tpu_torch.cli import download


def _stage(tmp_path):
    """Zips with the reference's internal layout, named as released."""
    staging = tmp_path / "zips"
    staging.mkdir()
    buf = io.BytesIO()
    np.save(buf, np.zeros((10, 3), np.float32))
    with zipfile.ZipFile(staging / download.DATASETS["abc"], "w") as z:
        z.writestr("abc/04_pts/x.xyz.npy", buf.getvalue())
        z.writestr("abc/testset.txt", "x\n")
    with zipfile.ZipFile(staging / download.MODELS["vanilla"], "w") as z:
        z.writestr("vanilla_model_149.pth", b"stub")
        z.writestr("vanilla_params.pth", b"stub")
    return staging


def test_download_from_local_zip(tmp_path, monkeypatch):
    staging = _stage(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = download.main(["--from_local_zip", str(staging), "datasets", "abc"])
    assert rc == 0
    assert (tmp_path / "datasets" / "abc" / "04_pts" / "x.xyz.npy").is_file()
    assert (tmp_path / "datasets" / "abc" / "testset.txt").read_text() == "x\n"
    rc = download.main(["--from_local_zip", str(staging), "models", "vanilla"])
    assert rc == 0
    assert (tmp_path / "models" / "vanilla_model_149.pth").is_file()
    # a missing zip: rc 1; an unknown name: rc 2; no directory: rc 2
    assert download.main(["--from_local_zip", str(staging), "models",
                          "max"]) == 1
    assert download.main(["--from_local_zip", str(staging), "models",
                          "nope"]) == 2
    assert download.main(["--from_local_zip"]) == 2


def test_download_and_unzip_file_url(tmp_path, monkeypatch):
    staging = _stage(tmp_path)
    target = tmp_path / "target"
    url = (staging / download.MODELS["vanilla"]).as_uri()
    assert url.startswith("file://")
    assert download.download_and_unzip(url, str(target))
    assert (target / "vanilla_params.pth").read_bytes() == b"stub"
    # the fetched zip is removed after extraction; the source stays
    assert not (target / download.MODELS["vanilla"]).exists()
    assert (staging / download.MODELS["vanilla"]).is_file()
    assert not download.download_and_unzip(
        (staging / "missing.zip").as_uri(), str(target))

    # main's download path, from a file:// base URL
    monkeypatch.setattr(download, "BASE_URL", staging.as_uri() + "/")
    monkeypatch.chdir(tmp_path)
    assert download.main(["datasets", "abc"]) == 0
    assert (tmp_path / "datasets" / "abc" / "testset.txt").read_text() == "x\n"
    assert download.main(["models", "max"]) == 1
