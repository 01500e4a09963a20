"""The port's MedNeXt with the patchify stems (the fast recipe's (1,2,2) and
the isotropic (2,2,2)) and the linear ConvTranspose head against flax
``MedNeXt.apply`` in f32; tolerances as in test_torch_model.py, which also
holds the bf16 case of the (1,2,2) stem."""

import pytest

from test_torch_model import assert_close, run_pair, tiny_cfg


@pytest.mark.parametrize(
    "stride,shape,dtype",
    [
        ((1, 2, 2), (2, 16, 32, 32, 1), "float32"),
        ((2, 2, 2), (1, 32, 32, 32, 1), "float32"),
    ],
)
def test_patchify_stem_matches_flax(stride, shape, dtype):
    got, ref = run_pair(tiny_cfg(dtype, stride), shape, seed=5)
    assert_close(got, ref, dtype)
