"""The PyTorch port imports without JAX, flax or the JAX package, and never
names them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "efficientat_tpu_torch"

SLICE_MODULES = [
    "efficientat_tpu_torch",
    "efficientat_tpu_torch.cli",
    "efficientat_tpu_torch.data",
    "efficientat_tpu_torch.data.audio_io",
    "efficientat_tpu_torch.data.audioset",
    "efficientat_tpu_torch.data.core",
    "efficientat_tpu_torch.data.dcase20",
    "efficientat_tpu_torch.data.esc50",
    "efficientat_tpu_torch.data.fsd50k",
    "efficientat_tpu_torch.data.hdf5",
    "efficientat_tpu_torch.data.native",
    "efficientat_tpu_torch.data.openmic",
    "efficientat_tpu_torch.data.wavecodec",
    "efficientat_tpu_torch.infer",
    "efficientat_tpu_torch.infer.tag",
    "efficientat_tpu_torch.infer.windowed",
    "efficientat_tpu_torch.models",
    "efficientat_tpu_torch.models.convert",
    "efficientat_tpu_torch.models.dymn",
    "efficientat_tpu_torch.models.ensemble",
    "efficientat_tpu_torch.models.layers",
    "efficientat_tpu_torch.models.mn",
    "efficientat_tpu_torch.models.registry",
    "efficientat_tpu_torch.ops",
    "efficientat_tpu_torch.ops._build",
    "efficientat_tpu_torch.ops.filterbank",
    "efficientat_tpu_torch.ops.mel_kernel",
    "efficientat_tpu_torch.ops.mel_probe",
    "efficientat_tpu_torch.ops.melspec",
    "efficientat_tpu_torch.parallel",
    "efficientat_tpu_torch.parallel.ddp",
    "efficientat_tpu_torch.parallel.ensemble",
    "efficientat_tpu_torch.parallel.mesh",
    "efficientat_tpu_torch.tools",
    "efficientat_tpu_torch.tools.complexity",
    "efficientat_tpu_torch.tools.layer_plan",
    "efficientat_tpu_torch.tools.macs",
    "efficientat_tpu_torch.tools.peak_memory",
    "efficientat_tpu_torch.tools.probe_mel_kernel",
    "efficientat_tpu_torch.tools.receptive_field",
    "efficientat_tpu_torch.tools.time_k1",
    "efficientat_tpu_torch.train",
    "efficientat_tpu_torch.train.augment",
    "efficientat_tpu_torch.train.cli",
    "efficientat_tpu_torch.train.kd",
    "efficientat_tpu_torch.train.loop",
    "efficientat_tpu_torch.train.metrics",
    "efficientat_tpu_torch.train.schedules",
    "efficientat_tpu_torch.train.tasks",
    "efficientat_tpu_torch.utils",
    "efficientat_tpu_torch.utils.checkpointing",
    "efficientat_tpu_torch.utils.common",
    "efficientat_tpu_torch.utils.host",
    "efficientat_tpu_torch.utils.labels",
    "efficientat_tpu_torch.utils.logging",
    "efficientat_tpu_torch.utils.profiling",
]


def test_imports_with_jax_and_flax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['efficientat_tpu'] = None\n"
        f"for name in {SLICE_MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_train_runs_with_jax_and_flax_blocked(tmp_path):
    # the train path imports its data and logging modules when it runs
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['efficientat_tpu'] = None\n"
        "from efficientat_tpu_torch import cli\n"
        "cli.main(['train', 'esc50', '--synthetic', '2', '--batch_size', '2',\n"
        "          '--n_epochs', '1', '--model_width', '0.1', '--clip_seconds', '1',\n"
        "          '--num_workers', '1', '--device', 'cpu', '--ckpt_dir', 'ckpt'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert (tmp_path / "ckpt" / "epoch_000000.pt").exists()


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", src, re.M), path


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_import_in_port(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+efficientat_tpu(\.|\s)", src,
                         re.M), path
