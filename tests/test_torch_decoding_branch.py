"""The port's branch suite against the JAX package's: the fixtures of
``tests/unit/test_branch_and_tube.py`` and ``tests/unit/test_branch_cues.py``
and seeded tube scenes (drifting tubes with gaps, merged and mis-linked
tubes) through ``seg_2d`` -> ``branch_link`` -> ``branch_split`` ->
``branch_merge`` and each cue and merge step alone, labels bit for bit;
and the check that the port's ``branch_cues.py`` is its own text, not the
JAX file's."""

import difflib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

from pytorch_connectomics_tpu.decoding import branch as jb
from pytorch_connectomics_tpu.decoding import branch_cues as jbc
from pytorch_connectomics_tpu_torch.decoding import branch as pb
from pytorch_connectomics_tpu_torch.decoding import branch_cues as pbc

REPO = Path(__file__).resolve().parents[1]


def _fixtures(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "tests" / "unit" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CUES = _fixtures("test_branch_cues")


def _disk(shape, cy, cx, r):
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def tube_scene(seed, shape=(32, 96, 96), n_tubes=7):
    """Seeded tubes: disks of radius 2-5 drifting along z, some with a gap
    of 1-3 sections, some crossing others, and two that cross in an X
    (one component in the middle sections); returns (prediction (1, Z, Y,
    X) float32, ground-truth labels)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros(shape, np.uint32)
    for t, (y0, y1) in ((n_tubes + 1, (8, 40)), (n_tubes + 2, (40, 8))):
        for z in range(shape[0]):
            cy = y0 + (y1 - y0) * z / (shape[0] - 1)
            gt[z][_disk(shape[1:], cy, 24 + rng.uniform(-1, 1), 3.5) & (gt[z] == 0)] = t
    for t in range(1, n_tubes + 1):
        cy, cx = rng.uniform(12, shape[1] - 12), rng.uniform(12, shape[2] - 12)
        vy, vx = rng.uniform(-1.2, 1.2, 2)
        r = rng.uniform(2, 5)
        z0, z1 = sorted(rng.integers(0, shape[0], 2))
        z1 = max(z1, z0 + 8)
        gap = rng.integers(z0, z1) if rng.random() < 0.5 else -1
        for z in range(z0, min(z1, shape[0])):
            if 0 <= z - gap < rng.integers(1, 4):
                continue
            m = _disk(shape[1:], cy + vy * (z - z0), cx + vx * (z - z0), r + 0.5 * np.sin(z / 3))
            gt[z][m & (gt[z] == 0)] = t
    prob = ndimage.gaussian_filter((gt > 0).astype(np.float32), 0.7)
    prob = np.clip(prob + 0.25 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return prob[None], gt


def same(fn_p, fn_j, *args, **kw):
    got, want = fn_p(*args, **kw), fn_j(*args, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


# -- the fixtures of test_branch_and_tube.py --------------------------------------------------


def _merge_fixtures():
    out = []
    lab = np.zeros((6, 8, 8), np.uint32)
    lab[0:3, 2:6, 2:6] = 1
    lab[3:6, 2:6, 2:6] = 2
    out.append((lab, None, dict(min_overlap=4, min_size=20, weak_min_size=20)))
    lab = np.zeros((8, 12, 20), np.uint32)
    lab[0:4, 4:8, 4:16] = 1
    lab[4:8, 4:8, 4:10] = 2
    lab[4:8, 4:8, 10:16] = 3
    out.append((lab, None, dict(min_size=20, weak_min_size=10_000)))
    lab = np.zeros((6, 8, 8), np.uint32)
    lab[0:3, 2:6, 2:6] = 1
    lab[3:6, 2:6, 2:6] = 2
    aff = np.ones((3, 6, 8, 8), np.float32)
    out.append((lab, aff, dict(min_size=20, weak_min_size=20)))
    aff = aff.copy()
    aff[2, 3] = 0.0
    out.append((lab, aff, dict(min_size=20, weak_min_size=10_000, weak_max_gap=0)))
    lab = np.zeros((12, 24, 12), np.uint32)
    for z in range(5):
        lab[z, 2 + z:6 + z, 4:8] = 1
    for z in range(7, 12):
        lab[z, 2 + z:6 + z, 4:8] = 2
    out.append((lab, None, dict(min_size=20, weak_min_size=20, weak_max_gap=3, rounds=1)))
    return out


@pytest.mark.parametrize("case", range(5))
def test_branch_merge_fixtures_match_jax(case):
    lab, aff, kw = _merge_fixtures()[case]
    same(pb.branch_merge, jb.branch_merge, lab, affinity=aff, **kw)


def test_sections_link_split_fixtures_match_jax():
    pred = np.zeros((3, 8, 8), np.float32)
    pred[:, 1:3, 1:3] = 1.0
    pred[:, 5:7, 5:7] = 1.0
    sec = same(pb.seg_2d, jb.seg_2d, pred[None], threshold=0.5)
    assert len(np.unique(sec)) == 7
    pred = np.zeros((3, 8, 8), np.float32)
    pred[:, 2:6, 2:6] = 1.0
    linked = same(pb.branch_link, jb.branch_link, same(pb.seg_2d, jb.seg_2d, pred[None]), min_iou=0.3)
    assert len(np.unique(linked)) == 2
    lab = np.zeros((4, 16, 16), np.uint32)
    lab[:, 2:6, 2:6] = 1
    lab[:, 10:14, 10:14] = 1
    assert pb.multi_component_sections(lab) == jb.multi_component_sections(lab)
    out = same(pb.branch_split, jb.branch_split, lab)
    assert out[1, 3, 3] != out[1, 11, 11]
    lab = np.zeros((6, 12, 12), np.uint32)
    lab[:, 2:9, 2:9] = 1
    lab[2, 9, 5] = 2
    same(pb.complete_fragments, jb.complete_fragments, lab, min_size=50)


def test_longrange_guided_split_matches_jax(tmp_path):
    primary = np.zeros((8, 10, 30), np.uint32)
    primary[:, 2:8, 2:28] = 1
    guide = np.zeros_like(primary)
    guide[:, 3:7, 3:12] = 5
    guide[:, 3:7, 18:27] = 9
    kw = dict(min_parent_voxels=500, min_seed_voxels=100, min_seed_overlap_voxels=50)
    got = same(pb.longrange_guided_split, jb.longrange_guided_split, primary, guide_seg=guide, **kw)
    assert len(np.unique(got)) == 3
    pb.longrange_guided_split(primary, guide_seg=guide, report_dir=str(tmp_path / "p"), **kw)
    jb.longrange_guided_split(primary, guide_seg=guide, report_dir=str(tmp_path / "j"), **kw)
    assert (tmp_path / "p" / "longrange_guided_split.csv").read_text() == \
        (tmp_path / "j" / "longrange_guided_split.csv").read_text()
    rng = np.random.default_rng(4)
    aff = rng.random((6, 8, 10, 30)).astype(np.float32)
    aff[3:, :, :, 14:16] = 0.05  # weak long-range support across the slab's middle
    same(pb.longrange_guided_split, jb.longrange_guided_split, primary, affinity=aff, min_size=10)


# -- the fixtures of test_branch_cues.py -----------------------------------------------------


GATES = dict(host_min=1000, cand_min=100, min_end_area=20)


def test_link_cut_fixtures_match_jax():
    for seg, kw in ((CUES._mislinked_tube(), dict(min_size=100)),
                    (CUES._mislinked_tube(jump_z=3), dict(min_size=100, min_frag=6))):
        got, want = pbc.link_cut_change(seg, **kw), jbc.link_cut_change(seg, **kw)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    seg = np.zeros((60, 48, 48), np.uint32)
    seg[:, 8:16, 8:16] = 1
    seg[30] = 0
    seg[30, 30:38, 30:38] = 1
    for recover in (0.4, 1.0):
        got = pbc.link_cut_change(seg, min_size=100, recover=recover)
        want = jbc.link_cut_change(seg, min_size=100, recover=recover)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_area_bump_fixtures_match_jax():
    seg = np.zeros((50, 40, 40), np.uint32)
    taper = seg.copy()
    for z in range(50):
        seg[z][CUES._disk((40, 40), 20, 20, 3 if not 20 <= z < 26 else 6)] = 1
        r = 2 + z if z < 4 else 2 + (49 - z) if z >= 46 else 6
        taper[z][CUES._disk((40, 40), 20, 20, r)] = 1
    for vol, kw in ((seg, dict(taper=4)), (seg, dict(taper=0)), (taper, dict(taper=5)), (seg, dict(taper=2, w=3))):
        got = pbc.sustained_area_bump(vol, min_size=100, min_run=3, **kw)
        assert got == jbc.sustained_area_bump(vol, min_size=100, min_run=3, **kw)


def test_containment_fixtures_match_jax():
    seg, info = CUES._tunnel_volume()
    pairs_p = pbc.detect_confident(seg, *pbc.seg_stats(seg), **GATES)
    pairs_j = jbc.detect_confident(seg, *jbc.seg_stats(seg), **GATES)
    assert len(pairs_p) == len(pairs_j) == 1
    for fp, fj in zip(pairs_p, pairs_j):
        assert fp.keys() == fj.keys()
        for k in fp:
            assert np.array_equal(fp[k], fj[k])
    for kw in (GATES, dict(GATES, drift_hi=0.01), dict(GATES, anchor_nm=400.0)):
        got, want = pbc.confident_parallel_split(seg, **kw), jbc.confident_parallel_split(seg, **kw)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    for kw in (GATES, dict(GATES, host_both=True)):
        out = same(pb.branch_split, jb.branch_split, seg, component=False, link_cut=False,
                   host_both=kw.pop("host_both", False), gates=kw)
        assert len(np.unique(out)) >= 3
    with pytest.raises(TypeError, match="unknown gate"):
        pbc.confident_parallel_split(seg, no_such_gate=1)
    host_only = seg.copy()
    host_only[host_only == 3] = 0
    host_only[info["z1"] + 1:info["z2"]][CUES._disk(seg.shape[1:], info["P"], info["P"], 14)[None]
                                        .repeat(info["z2"] - info["z1"] - 1, 0)] = 3
    assert pbc.detect_confident(host_only, *pbc.seg_stats(host_only), **GATES) == []


# -- seeded tube scenes ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tube_scene_chain_matches_jax(seed):
    """seg_2d -> branch_link -> branch_split (every cue on, gates sized to
    the scene) -> branch_merge, each step's labels equal."""
    prob, _ = tube_scene(seed)
    sections = same(pb.seg_2d, jb.seg_2d, prob, threshold=0.5, min_size=6)
    tracklets = same(pb.branch_link, jb.branch_link, sections, min_iou=0.3, max_gap=2)
    split = same(pb.branch_split, jb.branch_split, tracklets, min_size=20, link_min_size=200, min_frag=3,
                 gates=dict(host_min=300, cand_min=40, min_end_area=8, cand_span=4))
    merged = same(pb.branch_merge, jb.branch_merge, split, affinity=prob[0], min_size=30, weak_min_size=40)
    assert len(np.unique(merged)) > 3
    for kw in (dict(min_size=80), dict(min_size=20, zfrag_iou=0.1)):
        same(pb.complete_fragments, jb.complete_fragments, split, **kw)


@pytest.mark.parametrize("seed", [3, 4])
def test_tube_scene_merge_steps_match_jax(seed):
    """The merge chain's steps alone on over-segmented tubes (each tube cut
    into z pieces), with and without affinities."""
    prob, gt = tube_scene(seed, shape=(28, 80, 80))
    cut = np.where(gt > 0, gt * 4 + np.arange(gt.shape[0])[:, None, None] // 6, 0).astype(np.uint32)
    aff = np.stack([prob[0]] * 3)
    for a in (None, aff[2]):
        same(pb.merge_mutual_iou, jb.merge_mutual_iou, cut, a, min_size=20)
        same(pb.bridge_weak_gaps, jb.bridge_weak_gaps, cut, a, min_size=20, max_gap=3)
    merged = same(pb.branch_merge, jb.branch_merge, cut, affinity=aff, min_size=20, weak_min_size=20)
    assert len(np.unique(merged)) < len(np.unique(cut))


def test_mislinked_scene_cut_matches_jax():
    """Tracklets joined across tubes: the change-point cut on a scene of
    jumping tubes."""
    rng = np.random.default_rng(9)
    seg = np.zeros((48, 64, 64), np.uint32)
    for t in range(1, 4):
        jump = int(rng.integers(14, 34))
        a, b = rng.uniform(10, 54, 2), rng.uniform(10, 54, 2)
        for z in range(48):
            c = a if z < jump else b
            seg[z][_disk((64, 64), c[0], c[1], 3.5) & (seg[z] == 0)] = t
    got, want = pbc.link_cut_change(seg, min_size=200), jbc.link_cut_change(seg, min_size=200)
    assert got[1] == want[1] >= 1 and np.array_equal(got[0], want[0])


def test_branch_cues_is_not_a_copy():
    """The port's ``branch_cues.py`` against the JAX file: difflib's true
    ratio of their lines under 0.2, and no run of four or more equal lines
    inside a function body."""
    jax_lines = (REPO / "pytorch_connectomics_tpu/decoding/branch_cues.py").read_text().splitlines()
    port_lines = (REPO / "pytorch_connectomics_tpu_torch/decoding/branch_cues.py").read_text().splitlines()
    sm = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False)
    assert sm.ratio() < 0.2
    for block in sm.get_matching_blocks():
        body = [line for line in port_lines[block.b:block.b + block.size] if line.startswith("    ")]
        assert block.size < 4 or not body, port_lines[block.b:block.b + block.size]
