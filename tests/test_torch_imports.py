"""The port imports neither JAX nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mitsuba_tpu")


def test_import_loads_no_jax():
    code = ("import sys, mitsuba_tpu_torch, mitsuba_tpu_torch.ops.megakernel\n"
            "import mitsuba_tpu_torch.ops.megakernel_bvh, "
            "mitsuba_tpu_torch.ops.bvh, mitsuba_tpu_torch.ops.intersect\n"
            "import mitsuba_tpu_torch.utils.profile_path\n"
            "import mitsuba_tpu_torch.ops.intersect_packed, "
            "mitsuba_tpu_torch.ops.traverse, mitsuba_tpu_torch.core.distr, "
            "mitsuba_tpu_torch.core.distr2d, mitsuba_tpu_torch.utils.scenes, "
            "mitsuba_tpu_torch.models.integrators.path\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """No import statement anywhere in the package or chip_smoke.py names
    JAX or the JAX package, including imports inside functions."""
    files = sorted((ROOT / "mitsuba_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert len(files) > 15 and not bad, bad
