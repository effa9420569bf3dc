"""The import guard, the refusal without a card, and the benchmark's files
importing neither JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

from portbench import guard

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_guard_compares_whole_top_level_names():
    loaded = ["torch", "jax.numpy", "jaxlib", "blur_algorithms_tpu.api",
              "blur_algorithms_tpu_torch.api", "blur_algorithms_tpu_torch", "jaxtyping", "flax",
              "portbench.harness"]
    assert guard.forbidden_modules(loaded) == ["blur_algorithms_tpu.api", "flax", "jax.numpy",
                                               "jaxlib"]
    assert guard.forbidden_modules(["blur_algorithms_tpu_torch.cuda_kernels.fused_dma"]) == []
    assert guard.forbidden_modules(["blur_algorithms_tpu"]) == ["blur_algorithms_tpu"]


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_the_measured_process_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.run, portbench.harness, portbench.reference, portbench.control\n"
        "import blur_algorithms_tpu_torch.api\n"
        "from portbench import guard, manifest\n"
        "m = manifest.load()\n"
        "[m.reader(x['name']) for x in m.data['end_to_end'] + m.data['per_layer']]\n"
        "print(guard.forbidden_modules(sys.modules))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import portbench.reference, portbench.frames, portbench.peaks\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'blur_algorithms_tpu_torch', 'blur_algorithms_tpu', 'jax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_pin_devices_keeps_to_the_cards_given(monkeypatch):
    from portbench import run

    for given, chips, want in ((None, 1, "0"), (None, 4, "0,1,2,3"), ("3,5,6", 1, "3"),
                               ("", 1, ""), ("2", 4, "2")):
        if given is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", given)
        run.pin_devices(chips)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == want


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rgb4k-b32-s10",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result: {line}")
