"""Test sharding in the port against the JAX package: every case of the JAX
package's shard-planner tests gives the same ``ShardPlan`` in both, as do
the rank/world detection and the path helpers; then a tiny MedNeXt's test
leg on the CPU: two chunk-grid shards stitched (by the port's and by the
JAX package's ``stitch_shard_outputs``) equal the unsharded chunked
prediction bit for bit, the ``precomputed`` output reads back equal to it
too, and two volumes over two independent shards give each volume's
prediction and metrics of the unsharded run."""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu.config.schema import Config as JaxConfig
from pytorch_connectomics_tpu.config.schema import build_dataclass as jax_build_dataclass
from pytorch_connectomics_tpu.inference.chunked import stitch_shard_outputs as jax_stitch
from pytorch_connectomics_tpu.runtime import sharding as jsh
from pytorch_connectomics_tpu_torch.config import load_config
from pytorch_connectomics_tpu_torch.config.schema import Config, build_dataclass
from pytorch_connectomics_tpu_torch.data.io import read_volume
from pytorch_connectomics_tpu_torch.inference.chunked import stitch_shard_outputs
from pytorch_connectomics_tpu_torch.inference.output import stored_prediction_path
from pytorch_connectomics_tpu_torch.models import build_model
from pytorch_connectomics_tpu_torch.runtime import sharding as psh
from pytorch_connectomics_tpu_torch.runtime.test_pipeline import run_test_pipeline

NISB = "tutorials/neuron_nisb.yaml"
TINY = [
    "model.mednext.size=custom",
    "model.mednext.base_channels=8",
    "model.mednext.exp_ratio=2",
    "model.mednext.block_counts=[1,1,1,1,1,1,1,1,1]",
    "optimization.precision=32",
    "model.input_size=[16,16,16]",
    "inference.window.window_size=[16,16,16]",
    "inference.window.sw_batch_size=4",
    "inference.chunked.chunk_size=[16,24,24]",
    "inference.chunked.halo=[2,4,4]",
    "evaluation.metrics=[voi]",
]

# the cases of the JAX package's shard-planner tests: (config, volumes, devices, env)
PLAN_CASES = {
    "default": ({}, 3, 1, {}),
    "explicit": ({"system": {"shard_id": 1, "num_shards": 2}}, 5, 1, {}),
    "empty_shard": ({"system": {"shard_id": 3, "num_shards": 4}}, 2, 1, {}),
    "chunk_grid": ({"system": {"shard_id": 0, "num_shards": 4},
                    "inference": {"chunked": {"enabled": True, "chunk_size": [32, 64, 64]}}}, 1, 1, {}),
    "env_rank_world": ({}, 6, 1, {"RANK": "1", "WORLD_SIZE": "3"}),
    "env_slurm": ({}, 6, 1, {"SLURM_PROCID": "2", "SLURM_NTASKS": "4"}),
    "env_single_volume": ({}, 1, 1, {"RANK": "1", "WORLD_SIZE": "3"}),
    "tta_multivolume": ({"inference": {"test_time_augmentation": {"enabled": True, "rotation90": True}}}, 3, 4, {}),
    "tta_single_volume": ({"inference": {"test_time_augmentation": {"enabled": True, "flip_axes": "all"}}}, 1, 32,
                          {}),
    "fewer_volumes": ({}, 2, 8, {}),
    "chunked_many_devices": ({"inference": {"chunked": {"enabled": True}}}, 2, 8, {}),
    "one_shard": ({"system": {"shard_id": 0, "num_shards": 1}}, 3, 1, {}),
}


def configs(over):
    d = {"model": {"arch": {"type": "mednext"}}, **over}
    return build_dataclass(Config, d), jax_build_dataclass(JaxConfig, d)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_shard_plan_matches_jax(case, monkeypatch):
    over, volumes, devices, env = PLAN_CASES[case]
    for k in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, jcfg = configs(over)
    got = psh.plan_test_sharding(cfg, num_volumes=volumes, num_devices=devices)
    assert dataclasses.asdict(got) == dataclasses.asdict(jsh.plan_test_sharding(jcfg, volumes, devices))
    assert psh.detect_rank_world() == jsh.detect_rank_world()
    # the same plan from an explicit environment
    assert psh.plan_test_sharding(cfg, volumes, devices, env=env) == got
    assert dataclasses.asdict(psh.plan_test_sharding(cfg, volumes, devices, env={"RANK": "x", "WORLD_SIZE": "2"})) \
        == dataclasses.asdict(jsh.plan_test_sharding(jcfg, volumes, devices, env={"RANK": "x", "WORLD_SIZE": "2"}))


@pytest.mark.parametrize("system,match", [({"shard_id": 3, "num_shards": 2}, "out of range"),
                                          ({"num_shards": 4}, "requires"), ({"num_shards": 0}, "positive"),
                                          ({"shard_id": -1, "num_shards": 2}, "out of range")])
def test_shard_plan_raises_as_jax(system, match):
    cfg, jcfg = configs({"system": system})
    with pytest.raises(ValueError, match=match) as got:
        psh.plan_test_sharding(cfg, num_volumes=4)
    with pytest.raises(ValueError) as want:
        jsh.plan_test_sharding(jcfg, num_volumes=4)
    assert str(got.value) == str(want.value)


def test_path_helpers_match_jax():
    images = [f"im{i}.h5" for i in range(5)]
    labels = [f"lb{i}.h5" for i in range(5)]
    for shard, n in ((None, None), (0, 1), (1, 2), (2, 3), (4, 5), (0, 7)):
        assert psh.shard_paths(images, shard, n) == jsh.shard_paths(images, shard, n)
        for im, lb in psh.shard_paths(list(zip(images, labels)), shard, n):
            assert im[2:] == lb[2:]  # images and labels sharded together
    for rank, world in ((0, 1), (1, 2), (3, 4)):
        assert psh.assign_volumes_to_ranks(images, rank, world) == jsh.assign_volumes_to_ranks(images, rank, world)
    for devices, volumes in ((8, 2), (2, 8), (4, 0), (1, 1)):
        assert psh.effective_devices_for_volumes(devices, volumes) == jsh.effective_devices_for_volumes(devices,
                                                                                                         volumes)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Two seeded synthetic instance volumes with labels, and the tiny
    MedNeXt, random weights from the seed."""
    root = tmp_path_factory.mktemp("sharding")
    vols = {}
    for name, seed in (("a", 51), ("b", 52)):
        for kind in ("im", "label"):
            vols[name, kind] = root / f"vol{name}_{kind}.npy"
            np.save(vols[name, kind], read_volume(f"synthetic://instance/{name}_{kind}?shape=16,40,40&seed={seed}"))
    cfg = load_config(NISB, overrides=TINY, mode="test")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield vols, build_model(cfg.model, device="cpu", seed=0)
    torch.set_num_threads(n)


def run(tmp_path, model, name, over):
    run_test_pipeline(load_config(NISB, overrides=TINY + over, mode="test"), model, tmp_path / name, None, "cpu")
    return tmp_path / name


def test_chunk_grid_shards_stitch_to_the_unsharded_run(tmp_path, tiny):
    vols, model = tiny
    over = [f"data.test.image={vols['a', 'im']}", "data.test.label=null", "decoding.enabled=false",
            "evaluation.enabled=false"]
    name = "vola_scratch_prediction.h5"
    whole = read_volume(str(stored_prediction_path(run(tmp_path, model, "whole", over) / name)))
    shards = [stored_prediction_path(run(tmp_path, model, f"s{s}", over + [f"system.shard_id={s}",
                                                                           "system.num_shards=2"]) / name)
              for s in (0, 1)]
    parts = [read_volume(str(p)) for p in shards]
    assert whole.shape == (3, 16, 40, 40) and all(0 < np.count_nonzero(p) < whole.size for p in parts)
    stitched = stitch_shard_outputs(shards, tmp_path / "stitched.h5")
    assert np.array_equal(read_volume(str(stitched)), whole)
    if stitched.suffix == ".h5":  # the JAX package's stitch reads the port's shard files
        assert np.array_equal(read_volume(str(jax_stitch(shards, tmp_path / "jax_stitched.h5"))), whole)
    layer = run(tmp_path, model, "pre", over + ["inference.chunked.output_mode=precomputed"])
    from pytorch_connectomics_tpu_torch.data.precomputed import open_precomputed

    pre = open_precomputed(layer / name.replace(".h5", ".precomputed"))
    assert np.array_equal(pre.read((slice(0, 16), slice(0, 40), slice(0, 40))), whole)


def test_independent_shards_match_the_unsharded_run(tmp_path, tiny):
    vols, model = tiny
    over = [f"data.test.image=[{vols['a', 'im']},{vols['b', 'im']}]",
            f"data.test.label=[{vols['a', 'label']},{vols['b', 'label']}]", "inference.chunked.enabled=false"]
    cfg = load_config(NISB, overrides=TINY + over, mode="test")
    whole = run_test_pipeline(cfg, model, tmp_path / "whole", None, "cpu")
    assert sorted(whole) == ["vola", "volb"]
    for s, vol in ((0, "vola"), (1, "volb")):
        cfg = load_config(NISB, overrides=TINY + over + [f"system.shard_id={s}", "system.num_shards=2"], mode="test")
        got = run_test_pipeline(cfg, model, tmp_path / f"s{s}", None, "cpu")
        assert got == {vol: whole[vol]}  # its volume, scored on its own labels
        name = f"{vol}_scratch_prediction.h5"
        assert np.array_equal(read_volume(str(stored_prediction_path(tmp_path / f"s{s}" / name))),
                              read_volume(str(stored_prediction_path(tmp_path / "whole" / name))))
        assert not cfg.inference.test_time_augmentation.shard_across_devices
    cfg = load_config(NISB, overrides=TINY + over + ["system.shard_id=2", "system.num_shards=3"], mode="test")
    assert run_test_pipeline(cfg, model, tmp_path / "empty", None, "cpu") == {}


def test_truncated_h5_is_not_a_cache(tmp_path):
    """A prediction file cut short by a killed run is recomputed, not
    decoded as a whole prediction; the JAX package still accepts it (a
    divergence on purpose), and a format without attrs stays accepted."""
    pytest.importorskip("h5py")
    from pytorch_connectomics_tpu.inference.output import validate_prediction_cache as jax_validate
    from pytorch_connectomics_tpu_torch.inference.output import save_prediction, validate_prediction_cache

    pred = np.random.default_rng(0).random((3, 8, 32, 32)).astype(np.float32)
    path = save_prediction(tmp_path / "v_prediction.h5", pred, "hash", "ckpt")
    assert validate_prediction_cache(path, "hash", "ckpt") and jax_validate(path, "hash", "ckpt")
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    assert not validate_prediction_cache(path, "hash", "ckpt")
    assert jax_validate(path, "hash", "ckpt")
    np.save(tmp_path / "legacy.npy", pred)
    assert validate_prediction_cache(tmp_path / "legacy.npy", "hash", "ckpt")
