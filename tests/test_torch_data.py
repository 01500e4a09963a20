"""The port's volume io and intensity normalisation against the JAX package's."""

import numpy as np
import pytest

from pytorch_connectomics_tpu.data.io import read_volume as jax_read_volume
from pytorch_connectomics_tpu.data.preprocess import normalize_volume as jax_normalize_volume
from pytorch_connectomics_tpu_torch.data.io import read_volume, save_volume
from pytorch_connectomics_tpu_torch.data.preprocess import normalize_volume


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("method", ["smart", "zscore", "percentile", "scale", "none"])
def test_normalize_matches_jax(dtype, method):
    rng = np.random.default_rng(0)
    hi = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 3.0
    vol = (rng.random((5, 6, 7)) * hi).astype(dtype)
    got, want = normalize_volume(vol, method), jax_normalize_volume(vol, method)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["vol.npy", "vol.h5", "vol.h5:raw"])
def test_io_roundtrip_and_jax_reads_it(tmp_path, name):
    vol = np.random.default_rng(1).integers(0, 255, (4, 5, 6), dtype=np.uint8)
    path = str(tmp_path / name)
    save_volume(path, vol, attrs={"k": "v"} if ".h5" in name else None)
    np.testing.assert_array_equal(read_volume(path), vol)
    np.testing.assert_array_equal(jax_read_volume(path), vol)
    np.testing.assert_array_equal(read_volume(path, roi=(slice(1, 3),)), vol[1:3])


def test_unsupported_formats_raise(tmp_path):
    with pytest.raises(ValueError):
        read_volume(str(tmp_path / "vol.tif"))
    with pytest.raises(ValueError):
        save_volume(str(tmp_path / "vol.zarr"), np.zeros((2, 2, 2)))
