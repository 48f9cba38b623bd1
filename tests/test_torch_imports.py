"""The port imports neither JAX nor the JAX package, nor the imaging
packages (OpenCV, PIL) that the JAX package reads and writes images
with: its image codecs are its own."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mitsuba_tpu", "cv2", "PIL")


def test_import_loads_no_jax():
    code = ("import sys, mitsuba_tpu_torch, mitsuba_tpu_torch.ops.megakernel\n"
            "import mitsuba_tpu_torch.ops.megakernel_bvh, "
            "mitsuba_tpu_torch.ops.bvh, mitsuba_tpu_torch.ops.intersect\n"
            "import mitsuba_tpu_torch.utils.profile_path, "
            "mitsuba_tpu_torch.utils.refit_cost\n"
            "import mitsuba_tpu_torch.ops.intersect_packed, "
            "mitsuba_tpu_torch.ops.traverse, mitsuba_tpu_torch.core.distr, "
            "mitsuba_tpu_torch.core.distr2d, mitsuba_tpu_torch.utils.scenes, "
            "mitsuba_tpu_torch.models.integrators.path\n"
            "import mitsuba_tpu_torch.models.integrators.prb, "
            "mitsuba_tpu_torch.models.integrators.prb_basic, "
            "mitsuba_tpu_torch.models.integrators.projective, "
            "mitsuba_tpu_torch.models.integrators.guiding, "
            "mitsuba_tpu_torch.models.integrators.projection, "
            "mitsuba_tpu_torch.models.analytic, "
            "mitsuba_tpu_torch.models.sdf, "
            "mitsuba_tpu_torch.models.instancing, "
            "mitsuba_tpu_torch.ops.gather, "
            "mitsuba_tpu_torch.utils.largesteps, "
            "mitsuba_tpu_torch.utils.params, "
            "mitsuba_tpu_torch.utils.optimizers\n"
            "import mitsuba_tpu_torch.lens, mitsuba_tpu_torch.lens.design, "
            "mitsuba_tpu_torch.lens.camera, mitsuba_tpu_torch.lens.elements, "
            "mitsuba_tpu_torch.lens.designs, "
            "mitsuba_tpu_torch.lens.materials, mitsuba_tpu_torch.core.qmc, "
            "mitsuba_tpu_torch.models.integrators.ptracer, "
            "mitsuba_tpu_torch.core.spectrum, "
            "mitsuba_tpu_torch.utils.elastic, "
            "mitsuba_tpu_torch.utils.checkpoint, "
            "mitsuba_tpu_torch.utils.logging, "
            "mitsuba_tpu_torch.examples.doublet_achromat_design, "
            "mitsuba_tpu_torch.examples.triplet_efl_design\n"
            "import mitsuba_tpu_torch.__main__, "
            "mitsuba_tpu_torch.utils.load, mitsuba_tpu_torch.utils.xml, "
            "mitsuba_tpu_torch.utils.bitmap, "
            "mitsuba_tpu_torch.utils.mesh_io, "
            "mitsuba_tpu_torch.models.spectra, "
            "mitsuba_tpu_torch.models.emitters, "
            "mitsuba_tpu_torch.models.integrators.depth\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """No import statement anywhere in the package or chip_smoke.py names
    JAX, the JAX package, OpenCV or PIL, including imports inside
    functions."""
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
