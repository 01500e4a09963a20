"""The port's affinity QC and streamed decoding against the JAX package's:
the QC scan (report fields, markdown, keep mask) with and without the
image, the report file, the streaming accumulator, the decoding stage with
the QC mask; the streamed ``affinity_cc`` and ``waterz`` decodes against
the whole-volume decodes of both packages on several chunk grids, and the
streamed stage. Labels bit for bit, floats within 1e-6 relative."""

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.decoding import decoders as jdec
from pytorch_connectomics_tpu.decoding import qc as jqc
from pytorch_connectomics_tpu.decoding import streamed as jst
from pytorch_connectomics_tpu.decoding.stage import run_decoding_stage as jax_run_decoding_stage
from pytorch_connectomics_tpu.decoding.stage import run_streamed_decoding_stage as jax_streamed_stage
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.decoding import decoders as pdec
from pytorch_connectomics_tpu_torch.decoding import qc as pqc
from pytorch_connectomics_tpu_torch.decoding import streamed as pst
from pytorch_connectomics_tpu_torch.decoding.stage import run_decoding_stage, run_streamed_decoding_stage

WATERZ = "tutorials/waterz_decoding_large.yaml"


def quantized_affinities(seed=0, shape=(24, 48, 40)):
    """Seeded (3, Z, Y, X) affinities on the 8-bit grid (k / 255) of a
    tiling of watershed cells: about 0.85 between voxels of one cell, 0.2
    across cells, with noise; dark first and last sections for the QC's
    cuts."""
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.standard_normal(shape), 1.5)
    cells = ndimage.watershed_ift((255 * (f - f.min()) / np.ptp(f)).astype(np.uint8),
                                  ndimage.label(f > 1.5 * f.std())[0])
    aff = np.stack([np.where(cells == np.roll(cells, 1, axis=a), 0.85, 0.2) for a in (2, 1, 0)])
    aff = np.clip(aff + 0.15 * rng.standard_normal(aff.shape), 0, 1)
    aff[:, :2] *= 0.2
    aff[:, -1] *= 0.1
    return (np.round(aff * 255) / 255).astype(np.float32)


def image_of(seed, shape):
    rng = np.random.default_rng(seed + 100)
    img = rng.integers(40, 255, shape).astype(np.uint8)
    img[:, :6] = rng.integers(0, 20, img[:, :6].shape)  # a dark border band
    return img


def assert_reports_equal(got, want):
    for name, value in vars(want).items():
        mine = getattr(got, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_allclose(mine, value, rtol=1e-6)
        else:
            assert mine == value, name


@pytest.mark.parametrize("with_image", [False, True])
def test_qc_scan_matches_jax(with_image, tmp_path):
    aff = quantized_affinities(1)
    img = image_of(1, aff.shape[1:]) if with_image else None
    for kw in (dict(), dict(z_mean_drift=0.2, border_width=4)):
        mask, report = pqc.scan_affinity_quality(aff, img=img, **kw)
        jmask, jreport = jqc.scan_affinity_quality(aff, img=img, **kw)
        assert np.array_equal(mask, jmask)
        assert_reports_equal(report, jreport)
    params = dict(z_stride=3, k_edge=2, refine_window=6, drift_thresh=0.05, border_width=6, bg_thresh=30.0,
                  n_z_border=4)
    report = pqc.scan_prediction(aff, img=img, params=pqc.AffinityQCParams(**params))
    jreport = jqc.scan_prediction(aff, img=img, params=jqc.AffinityQCParams(**params))
    assert_reports_equal(report, jreport)
    assert report.low_z >= 1 and report.high_z < aff.shape[1]  # the dark sections are cut
    meta = dict(pred_desc="aff", img_desc="img", mask_path="m.h5", image_path="i.h5")
    assert report.to_markdown(pqc.AffinityQCParams(**params), **meta) == \
        jreport.to_markdown(jqc.AffinityQCParams(**params), **meta)
    pqc.write_qc_report(report, tmp_path / "p" / "qc.md", pqc.AffinityQCParams(**params))
    jqc.write_qc_report(jreport, tmp_path / "j" / "qc.md", jqc.AffinityQCParams(**params))
    assert (tmp_path / "p" / "qc.md").read_text() == (tmp_path / "j" / "qc.md").read_text()


def test_streaming_qc_accumulator_matches_jax():
    aff = quantized_affinities(2)
    acc, jacc = pqc.StreamingQCAccumulator(aff.shape[1]), jqc.StreamingQCAccumulator(aff.shape[1])
    for z0 in range(0, aff.shape[1], 5):
        for a in (acc, jacc):
            a.update(aff[:, z0:z0 + 5], z0)
    aff_nan = aff.copy()
    aff_nan[0, 3, 0, 0] = np.nan
    for a in (acc, jacc):
        a.update(aff_nan[:, 3:4] * 0, 3)  # adds NaN/Inf-free zeros to a section
    for kw in (dict(), dict(z_mean_drift=0.1), dict(params=None)):
        assert_reports_equal(acc.finalize(**kw), jacc.finalize(**kw))
    p = pqc.StreamingQCAccumulator(4)
    j = jqc.StreamingQCAccumulator(4)
    for a in (p, j):
        a.update(aff_nan[0, :4], 0)  # one channel, inferred lazily, with a NaN
    assert_reports_equal(p.finalize(), j.finalize())


@pytest.mark.parametrize("report", [False, True])
def test_decoding_stage_with_qc_matches_jax(report, tmp_path):
    aff = quantized_affinities(3)
    img = image_of(3, aff.shape[1:])
    cfg, jcfg = load_config(WATERZ, mode="test").decoding, jax_load_config(WATERZ, mode="test").decoding
    for c, name in ((cfg, "p"), (jcfg, "j")):
        c.qc.enabled = True
        c.qc.z_mean_drift = 0.3
        c.qc.report_path = str(tmp_path / name / "qc.md") if report else None
        c.steps = c.steps[:1]
        c.steps[0].kwargs = {"threshold": 0.7, "fragment_threshold": 0.3}
        c.postprocessing.min_instance_size = 20
    got = run_decoding_stage(aff, cfg, {"image": img})
    want = jax_run_decoding_stage(aff, jcfg, {"image": img})
    assert np.array_equal(got, want) and len(np.unique(got)) > 2
    if report:
        assert (tmp_path / "p" / "qc.md").read_text() == (tmp_path / "j" / "qc.md").read_text()


def _reader(aff):
    return lambda sl: aff[(slice(None),) + tuple(sl)]


CHUNKS = [(8, 16, 16), (24, 48, 40), (7, 13, 11), (24, 20, 40)]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_streamed_affinity_cc_equals_whole_and_jax(chunk):
    aff = quantized_affinities(4)
    for thr, min_size in ((0.75, 0), (0.5, 30)):
        got = pst.streamed_affinity_cc_decode(_reader(aff), aff.shape[1:], chunk, threshold=thr, min_size=min_size,
                                              num_workers=2)
        want = jst.streamed_affinity_cc_decode(_reader(aff), aff.shape[1:], chunk, threshold=thr, min_size=min_size)
        whole = pdec.decode_affinity_cc(aff, threshold=thr, min_size=min_size)
        jwhole = jdec.decode_affinity_cc(aff, threshold=thr, min_size=min_size)
        assert np.array_equal(whole, jwhole)
        assert np.array_equal(got, want) and len(np.unique(got)) > 3
        # the whole decode's ids in first-appearance order
        assert np.array_equal(got, pst.renumber(whole)[0])


@pytest.mark.parametrize("chunk", CHUNKS)
def test_streamed_waterz_equals_whole_and_jax(chunk):
    aff = quantized_affinities(5)
    for thr, frag, min_size in ((0.5, 0.9, 0), (0.3, 0.95, 25)):
        got = pst.streamed_waterz_decode(_reader(aff), aff.shape[1:], chunk, threshold=thr, fragment_threshold=frag,
                                         min_size=min_size, num_workers=2)
        want = jst.streamed_waterz_decode(_reader(aff), aff.shape[1:], chunk, threshold=thr, fragment_threshold=frag,
                                          min_size=min_size)
        whole = pdec.decode_waterz(aff, threshold=thr, fragments="cc", fragment_threshold=frag, min_size=min_size)
        assert np.array_equal(got, want) and len(np.unique(got)) > 3
        assert np.array_equal(got, pst.renumber(whole)[0])


def test_streamed_stage_matches_jax():
    aff = quantized_affinities(6)
    cfg, jcfg = load_config(WATERZ, mode="test").decoding, jax_load_config(WATERZ, mode="test").decoding
    for c in (cfg, jcfg):
        c.streamed, c.streamed_chunk = True, [8, 24, 24]
        c.steps = c.steps[:1]
        c.steps[0].kwargs = {"threshold": 0.4, "fragments": "cc", "min_size": 10}
    got = run_streamed_decoding_stage(_reader(aff), aff.shape[1:], cfg)
    assert np.array_equal(got, jax_streamed_stage(_reader(aff), aff.shape[1:], jcfg))
    cfg.streamed = False
    assert np.array_equal(got, run_decoding_stage(aff, cfg))  # the whole-volume stage
    for c in (cfg, jcfg):
        c.steps[0].name, c.steps[0].kwargs = "affinity_cc", {"threshold": 0.6}
    assert np.array_equal(run_streamed_decoding_stage(_reader(aff), aff.shape[1:], cfg),
                          jax_streamed_stage(_reader(aff), aff.shape[1:], jcfg))
    cfg.steps[0].name, cfg.steps[0].kwargs = "waterz", {"fragments": "watershed"}
    with pytest.raises(ValueError, match="fragments='cc'"):
        run_streamed_decoding_stage(_reader(aff), aff.shape[1:], cfg)


def test_union_find_keeps_the_smaller_root():
    uf, juf = pst.UnionFind(), jst.UnionFind()
    rng = np.random.default_rng(0)
    for a, b in rng.integers(0, 60, (80, 2)):
        uf.union(int(a), int(b))
        juf.union(int(a), int(b))
    assert {k: uf.find(k) for k in uf.parent} == {k: juf.find(k) for k in juf.parent}
    assert all(uf.find(k) <= k for k in uf.parent)
