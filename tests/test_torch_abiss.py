"""The ABISS bridge and the neuroglancer precomputed io in the port against
the JAX package, on the same seeded arrays: the precomputed layers (the
bytes of every file, both directions of read and write, channels, scales,
the kvstore specs), ABISS's affinity convention and the exported layer's
bytes, the parameter payload and its file, ``compute_top_mip`` and the
upload alignment check, each stage's argv and environment, the stage runner
on a stub ABISS root that records what it is run with, Seuron provenance
replay (JAX's fixture and its fail-closed refusals), the in-process waterz
decode without ``abiss_root`` (labels bit for bit) and the chunked
``precomputed`` output (within 1e-6 of JAX's, equal to the port's own HDF5
output)."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

pytest.importorskip("tensorstore")

from pytorch_connectomics_tpu.config import load_config as jax_load_config  # noqa: E402
from pytorch_connectomics_tpu.config.schema import ChunkedConfig as JaxChunkedConfig  # noqa: E402
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass  # noqa: E402
from pytorch_connectomics_tpu.data import precomputed as jpre  # noqa: E402
from pytorch_connectomics_tpu.decoding.stage import run_decoding_stage as jax_run_decoding_stage  # noqa: E402
from pytorch_connectomics_tpu.inference import LazyVolumeAccessor as JaxLazyVolumeAccessor  # noqa: E402
from pytorch_connectomics_tpu.inference import SlidingWindowEngine as JaxEngine  # noqa: E402
from pytorch_connectomics_tpu.inference import TTAPredictor as JaxTTAPredictor  # noqa: E402
from pytorch_connectomics_tpu.inference import run_chunked_inference as jax_run_chunked  # noqa: E402
from pytorch_connectomics_tpu.runtime import abiss_bridge as jab  # noqa: E402
from pytorch_connectomics_tpu_torch.config import load_config  # noqa: E402
from pytorch_connectomics_tpu_torch.config.schema import ChunkedConfig, build_dataclass  # noqa: E402
from pytorch_connectomics_tpu_torch.data import precomputed as ppre  # noqa: E402
from pytorch_connectomics_tpu_torch.data.io import read_volume, save_volume  # noqa: E402
from pytorch_connectomics_tpu_torch.decoding import get_decoder, run_decoding_stage  # noqa: E402
from pytorch_connectomics_tpu_torch.inference import LazyVolumeAccessor, SlidingWindowEngine, TTAPredictor  # noqa: E402
from pytorch_connectomics_tpu_torch.inference import run_chunked_inference  # noqa: E402
from pytorch_connectomics_tpu_torch.runtime import abiss_bridge as pab  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "unit" / "fixtures" / "seuron_provenance.json"
DECODING_ABISS = "tutorials/decoding_abiss.yaml"


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def seg_affinities(seed=0, shape=(8, 24, 24)):
    """Seeded deepem (x, y, z offset) affinities of smooth-field instances,
    with noise."""
    rng = np.random.default_rng(seed)
    lab = ndimage.label(ndimage.gaussian_filter(rng.standard_normal(shape), 2.0) > 0.1)[0]
    aff = np.stack([(lab == np.roll(lab, 1, axis=a)) & (lab > 0) for a in (2, 1, 0)]).astype(np.float32)
    return np.clip(0.8 * aff + 0.25 * rng.random(aff.shape, dtype=np.float32), 0, 1)


def test_precomputed_roundtrip_matches_jax(tmp_path):
    vol = np.random.default_rng(0).integers(0, 255, (8, 16, 32), dtype=np.uint8)
    full = (slice(0, 8), slice(0, 16), slice(0, 32))
    for mod in (ppre, jpre):
        mod.create_precomputed(tmp_path / mod.__name__, vol.shape, np.uint8, chunk_size=(4, 8, 16)).write(full, vol)
    assert tree_bytes(tmp_path / ppre.__name__) == tree_bytes(tmp_path / jpre.__name__)
    for writer in (ppre, jpre):
        for reader in (ppre, jpre):
            layer = reader.open_precomputed(tmp_path / writer.__name__)
            assert layer.shape == vol.shape
            assert np.array_equal(layer.read(full), vol)
            assert np.array_equal(layer[(slice(0, 4), slice(8, 16), slice(16, 32))], vol[:4, 8:, 16:])


def test_precomputed_multichannel_and_scales_match_jax(tmp_path):
    vol = np.random.default_rng(1).random((3, 4, 8, 8)).astype(np.float32)
    full = (slice(0, 4), slice(0, 8), slice(0, 8))
    for mod in (ppre, jpre):
        base = tmp_path / mod.__name__
        mod.create_precomputed(base, vol.shape[1:], np.float32, chunk_size=(4, 8, 8), num_channels=3,
                               resolution=(30, 6, 6)).write(full, vol)
        mod.append_scale(base, (4, 4, 4), np.float32, (4, 4, 4), (30, 12, 12), num_channels=3).write(
            (slice(0, 4), slice(0, 4), slice(0, 4)), vol[:, :, ::2, ::2])
    assert tree_bytes(tmp_path / ppre.__name__) == tree_bytes(tmp_path / jpre.__name__)
    layer = ppre.open_precomputed(tmp_path / jpre.__name__)
    assert layer.shape == vol.shape and np.array_equal(layer.read(full), vol)
    assert ppre.open_precomputed(tmp_path / jpre.__name__, resolution=[30, 12, 12]).shape == (3, 4, 4, 4)
    for path in ("gs://bkt/inner/layer", "s3://bkt/x", "https://host/a/b", "/local/dir", "rel/dir"):
        assert ppre.kvstore_spec(path) == jpre.kvstore_spec(path)


@pytest.mark.parametrize("shape", [(3, 2, 2, 4), (3, 5, 6, 7), (4, 1, 3, 3)])
def test_abiss_convention_matches_jax(shape):
    aff = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got, want = ppre.abiss_affinity_convention(aff), jpre.abiss_affinity_convention(aff)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prepare_abiss_run_matches_jax(tmp_path):
    """The same work directory prepared by each package in turn: the
    payload, its param file, the exported layer's bytes and the top mip."""
    aff = seg_affinities(2, (16, 32, 48))
    kw = dict(name="chunk7", chunk_size_xyz=(24, 16, 8), resolution_xyz=(8.0, 8.0, 40.0), ws_size=300,
              agg_threshold=0.35, paranoid=1)
    wd = tmp_path / "work"
    outcomes = []
    for mod in (jab, pab):
        shutil.rmtree(wd, ignore_errors=True)
        payload, secrets, top_mip = mod.prepare_abiss_run(aff, wd, **kw)
        outcomes.append((payload, str(secrets), top_mip, tree_bytes(wd)))
    assert outcomes[0] == outcomes[1]
    payload, _, top_mip, files = outcomes[1]
    assert top_mip == 1 and payload["WS_DUST_THRESHOLD"] == 300 and json.loads(files["secrets/param"]) == payload
    assert {"aff/info", "secrets/param"} <= set(files)


def test_export_matches_jax(tmp_path):
    aff = seg_affinities(3)
    for mod in (pab, jab):
        out = mod.export_affinity_for_abiss(aff, tmp_path / mod.__name__, resolution=(40, 8, 8), chunk_size=(4, 8, 8))
        assert out == tmp_path / mod.__name__ / "aff"
    assert tree_bytes(tmp_path / pab.__name__) == tree_bytes(tmp_path / jab.__name__)
    back = ppre.open_precomputed(tmp_path / jab.__name__ / "aff").read((slice(0, 8), slice(0, 24), slice(0, 24)))
    assert np.array_equal(back, ppre.abiss_affinity_convention(aff))


TOP_MIP_CASES = [([0, 0, 0, 512, 512, 128], [256, 256, 128]), ([0, 0, 0, 1, 1, 1], [64, 64, 64]),
                 ([10, 20, 30, 1000, 700, 90], [128, 64, 32]), ([0, 0, 0, 257, 256, 255], [256, 256, 256])]
ALIGN_CASES = [
    ([0, 0, 0, 512, 512, 128], [0, 0, 0], [256, 256, 128], [128, 128, 64]),
    ([0, 0, 0, 512, 512, 128], [0, 0, 0], [256, 256, 128], [96, 128, 64]),
    ([64, 0, 0, 576, 512, 128], [0, 0, 0], [256, 256, 128], [128, 128, 64]),
    ([0, 0, 0, 300, 300, 300], [0, 0, 0], [100, 150, 300], [100, 100, 7]),
]


def test_top_mip_and_alignment_match_jax():
    for bbox, chunk in TOP_MIP_CASES:
        assert pab.compute_top_mip(bbox, chunk) == jab.compute_top_mip(bbox, chunk)
    raised = 0
    for case in ALIGN_CASES:
        try:
            jab.validate_upload_alignment(*case)
        except ValueError as e:
            raised += 1
            with pytest.raises(ValueError) as got:
                pab.validate_upload_alignment(*case)
            assert str(got.value) == str(e)
        else:
            pab.validate_upload_alignment(*case)
    assert raised == 3


def test_stage_plans_match_jax(tmp_path):
    for stage in pab.STAGES_ALL:
        for kw in ({}, dict(root_tag="r2", overlap="1", meta="m", extra_env={"X_EXTRA": 3})):
            got = pab.stage_plan(tmp_path / "abiss", stage, tmp_path / "secrets", 3, **kw)
            want = jab.stage_plan(tmp_path / "abiss", stage, tmp_path / "secrets", 3, **kw)
            assert got.stage == want.stage and got.argv == want.argv and dict(got.env) == dict(want.env)
    with pytest.raises(ValueError, match="Unknown ABISS stage: nope"):
        pab.stage_plan(tmp_path, "nope", tmp_path, 0)


def stub_abiss_root(root: Path) -> Path:
    """An ABISS root whose batch scripts record their argv and stage
    variables, one line a call, in ``<root>/calls.log``."""
    (root / "scripts").mkdir(parents=True)
    for name in ("run_batch.sh", "remap_batch.sh"):
        (root / "scripts" / name).write_text(
            f'echo "{name} $* STAGE=$STAGE SECRETS=$SECRETS WORKER_HOME=$WORKER_HOME" >> "$WORKER_HOME/calls.log"\n')
    return root


def test_stage_runner_on_a_stub_root(tmp_path):
    logs = []
    for mod in (jab, pab):
        root = stub_abiss_root(tmp_path / mod.__name__)
        plans = mod.run_abiss_stages(root, tmp_path / "secrets", top_mip=2, root_tag="t")
        assert [p.stage for p in plans] == list(pab.STAGES_ALL)
        logs.append((root / "calls.log").read_text().replace(str(root), "<root>"))
    assert logs[0] == logs[1]
    assert logs[1].splitlines()[2] == (f"run_batch.sh me 2 t STAGE=agg SECRETS={tmp_path / 'secrets'} "
                                       "WORKER_HOME=<root>")
    for mod in (jab, pab):
        with pytest.raises(FileNotFoundError, match="ABISS installation not found") as e:
            mod.run_abiss_stages(tmp_path / "none", tmp_path / "secrets")
    assert str(e.value).startswith(f"ABISS installation not found at {tmp_path / 'none'}")


SEURON_SEG = {
    "AFF_PATH": "gs://bucket/aff", "AFF_MIP": 0, "AFF_RESOLUTION": [8, 8, 40], "BBOX": [0, 0, 0, 512, 512, 128],
    "CHUNK_SIZE": [256, 256, 128], "AGG_THRESHOLD": 0.25, "WS_HIGH_THRESHOLD": 0.99, "WS_LOW_THRESHOLD": 0.01,
    "WS_SIZE_THRESHOLD": 500, "WS_DUST_THRESHOLD": 500, "REDIS_SERVER": "ignored-infra", "IMAGE_PATH": "gs://b/img",
    "NAME": "recorded",
}


def _provenance(tmp_path, name, blocks):
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(blocks))
    return p


def test_seuron_replay_matches_jax(tmp_path):
    good = _provenance(tmp_path, "good", {"processing": [{"method": SEURON_SEG}, {"method": {"downsample": True}}]})
    assert pab.load_seuron_provenance(good) == jab.load_seuron_provenance(good)
    for kw in ({}, dict(name="run1", aff_override="/local/aff")):
        got = pab.replay_seuron_provenance(good, workdir=str(tmp_path), **kw)
        assert got == jab.replay_seuron_provenance(good, workdir=str(tmp_path), **kw)
        assert "REDIS_SERVER" not in got and got["IMAGE_PATH"] == "gs://b/img"
    bad = {
        "fixture": FIXTURE,  # JAX's own fixture: its blocks carry no ABISS segmentation keys
        "unknown_key": _provenance(tmp_path, "u", {"processing": [{"method": {**SEURON_SEG, "MYSTERY_KEY": 1}}]}),
        "missing_key": _provenance(tmp_path, "m", {"processing": [{"method": {
            k: v for k, v in SEURON_SEG.items() if k != "BBOX"}}]}),
        "two_blocks": _provenance(tmp_path, "t", {"processing": [{"method": SEURON_SEG}, {"method": SEURON_SEG}]}),
        "no_list": _provenance(tmp_path, "n", {"processing": {}}),
        "not_object": _provenance(tmp_path, "o", {"processing": [{"method": [1]}]}),
    }
    for case, path in list(bad.items()) + [("bad_name", good)]:
        name = "../x" if case == "bad_name" else "replay"
        with pytest.raises(ValueError) as want:
            jab.replay_seuron_provenance(path, workdir=str(tmp_path), name=name)
        with pytest.raises(ValueError) as got:
            pab.replay_seuron_provenance(path, workdir=str(tmp_path), name=name)
        assert str(got.value) == str(want.value), case


@pytest.mark.parametrize("seed", [0, 1])
def test_fallback_decode_matches_jax(seed):
    """Without ``abiss_root`` the decoder agglomerates through waterz, as
    JAX's does: labels bit for bit, at several thresholds and sizes, on
    three channels and on one."""
    aff = seg_affinities(seed)
    counts = []
    for kw in (dict(agg_threshold=0.3), dict(agg_threshold=0.6, ws_size=40), dict(workdir="unused", paranoid=1)):
        got, want = pab.decode_abiss(aff, **kw), jab.decode_abiss(aff, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        counts.append(len(np.unique(got)) - 1)
    assert max(counts) > 1, counts
    got, want = pab.decode_abiss(aff[0], agg_threshold=0.5), jab.decode_abiss(aff[0], agg_threshold=0.5)
    assert np.array_equal(got, want)
    assert get_decoder("abiss") is pab.decode_abiss
    with pytest.raises(ValueError, match="abiss decoder requires abiss_root"):
        pab.decode_abiss(aff, fallback=False)


def test_decoding_abiss_recipe_decodes_as_jax():
    """``decoding_abiss.yaml``'s decode as shipped (abiss at 0.2, then
    ``min_instance_size: 200``) through the decoding stage."""
    aff = seg_affinities(4, (12, 48, 48))
    cfg, jcfg = load_config(DECODING_ABISS, mode="test").decoding, jax_load_config(DECODING_ABISS, mode="test").decoding
    assert cfg.steps[0].name == "abiss"
    got, want = run_decoding_stage(aff, cfg), jax_run_decoding_stage(aff, jcfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() > 0


def test_chunked_precomputed_output_matches_jax(tmp_path):
    """An affine map of the input, two channels, over a 2 x 2 x 2 chunk
    grid into a precomputed layer: equal to the port's HDF5 output bit for
    bit and within 1e-6 of JAX's layer; resumed with the manifest whole, it
    computes nothing."""
    import jax.numpy as jnp

    vol = np.random.default_rng(5).integers(0, 255, (16, 32, 32), dtype=np.uint8)
    src = str(tmp_path / "src.h5")
    save_volume(src, vol)
    chunk = {"enabled": True, "chunk_size": [8, 16, 16], "halo": [2, 4, 4]}
    engine = SlidingWindowEngine(lambda w: torch.cat([w, 1 - 0.5 * w], -1), (8, 16, 16), overlap=0.5,
                                 sw_batch_size=2, device="cpu")
    jengine = JaxEngine(lambda p, w: jnp.concatenate([w, 1 - 0.5 * w], -1), (8, 16, 16), overlap=0.5,
                        sw_batch_size=2)
    out = run_chunked_inference(TTAPredictor(engine), LazyVolumeAccessor(src), tmp_path / "layer",
                                build_dataclass(ChunkedConfig, {**chunk, "output_mode": "precomputed"}),
                                out_channels=2, signature={"config_hash": "h"})
    jout = jax_run_chunked(JaxTTAPredictor(jengine), None, JaxLazyVolumeAccessor(src), tmp_path / "jlayer",
                           jax_build_dataclass(JaxChunkedConfig, {**chunk, "output_mode": "precomputed"}),
                           out_channels=2)
    h5 = run_chunked_inference(TTAPredictor(engine), LazyVolumeAccessor(src), tmp_path / "pred.h5",
                               build_dataclass(ChunkedConfig, chunk), out_channels=2)
    full = (slice(0, 16), slice(0, 32), slice(0, 32))
    got = ppre.open_precomputed(out).read(full)
    assert got.shape == (2, 16, 32, 32) and np.array_equal(got, read_volume(str(h5)))
    np.testing.assert_allclose(got, jpre.open_precomputed(jout).read(full), rtol=0, atol=1e-6)
    assert json.loads((tmp_path / "layer.manifest.json").read_text())["done"]
    before = os.path.getmtime(out / "info")
    run_chunked_inference(TTAPredictor(engine), LazyVolumeAccessor(src), tmp_path / "layer",
                          build_dataclass(ChunkedConfig, {**chunk, "output_mode": "precomputed"}), out_channels=2,
                          signature={"config_hash": "h"})
    assert os.path.getmtime(out / "info") == before and np.array_equal(ppre.open_precomputed(out).read(full), got)
