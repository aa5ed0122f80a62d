"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name starts with the JAX package's), and the
reference loads nothing of the program."""

import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT
FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'tpu_debruijn'}"


def python(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip()


def test_a_run_loads_no_jax():
    got = python(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import harness as H\n"
        "c = H.load_cell(H.ROOT, 'ecoli_err_k31_msp8.sharded')\n"
        "r, _ = H.run_cell(c, 5, 0.01, False, 'cpu', genome_length=20000)\n"
        "assert r['correct']\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN}), "
        "'tpu_debruijn_torch' in sys.modules, H.forbidden_modules())")
    assert got == "[] True []"


def test_reference_loads_nothing_of_the_program():
    got = python(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference, portbench.control, portbench.job\n"
        "for entry in ('library', 'sharded', 'cli'): portbench.job.load(entry)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('tpu_debruijn')))")
    assert got == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_debruijn_torch_fake", sys)
    assert "tpu_debruijn" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
