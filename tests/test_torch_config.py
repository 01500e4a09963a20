"""The port's own config copy against the JAX package's loader, the CLI's
overrides, the device rule, and the rule that the port imports nothing of
JAX."""

import subprocess
import sys
from pathlib import Path

import pytest

from pytorch_connectomics_tpu.config import load_config as jax_load_config
from pytorch_connectomics_tpu.config import to_dict as jax_to_dict
from pytorch_connectomics_tpu_torch.config import load_config, to_dict

REPO = Path(__file__).resolve().parents[1]
TUTORIALS = sorted(p.name for p in (REPO / "tutorials").glob("*.yaml"))
FAST = REPO / "tutorials" / "mito_lucchi_tpu_fast.yaml"


def _without_devices(d):
    # the only semantic edit: num_devices (and the mesh sized from it) count
    # CUDA devices in the port and JAX devices in the reference
    d["system"].pop("num_devices")
    d["system"].pop("mesh")
    return d


@pytest.mark.parametrize("name", TUTORIALS)
def test_loader_matches_jax(name):
    path = REPO / "tutorials" / name
    assert _without_devices(to_dict(load_config(path, mode="test"))) == _without_devices(
        jax_to_dict(jax_load_config(path, mode="test"))
    )


@pytest.mark.parametrize("tta", [False, True])
def test_cli_overrides_match_jax(tmp_path, tta):
    """The overrides chip_smoke.py gives the CLI (volume paths, TTA switch)
    resolve as the JAX package resolves them."""
    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args, setup_config

    overrides = [
        f"data.test.image={tmp_path / 'im.npy'}", f"data.test.label={tmp_path / 'mito.npy'}",
        f"inference.test_time_augmentation.enabled={str(tta).lower()}",
    ]
    cfg = setup_config(parse_args(["--config", str(FAST), "--mode", "test", "--device", "cpu", *overrides]))
    assert cfg.data.test.image == str(tmp_path / "im.npy")
    assert cfg.inference.test_time_augmentation.enabled is tta
    assert _without_devices(to_dict(cfg)) == _without_devices(
        jax_to_dict(jax_load_config(FAST, overrides=overrides, mode="test"))
    )


def test_cli_refuses_to_run_on_cpu_unasked():
    """Without --device cpu the CLI needs a GPU; on a machine without one it
    raises instead of running on the CPU."""
    import torch

    from pytorch_connectomics_tpu_torch.runtime.cli import parse_args
    from pytorch_connectomics_tpu_torch.runtime.dispatch import dispatch_runtime

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch_runtime(parse_args(["--config", str(FAST), "--mode", "test"]))
    with pytest.raises(NotImplementedError):
        dispatch_runtime(parse_args(["--config", str(FAST), "--mode", "tune", "--device", "cpu"]))


PORT_MODULES = [
    "pytorch_connectomics_tpu_torch." + ".".join(p.relative_to(REPO / "pytorch_connectomics_tpu_torch").with_suffix("").parts)
    for p in sorted((REPO / "pytorch_connectomics_tpu_torch").rglob("*.py"))
    if p.name != "__init__.py"
]


def test_port_imports_no_jax():
    """Every port module imports with jax, flax and the JAX package blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pytorch_connectomics_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    __import__(m)\n"
        "import chip_smoke\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(PORT_MODULES) >= 20
    for m in ("ops.conv3d", "ops.native", "models.rsunet", "decoding.registry", "decoding.decoders",
              "decoding.stage", "metrics.seg"):
        assert "pytorch_connectomics_tpu_torch." + m in PORT_MODULES
