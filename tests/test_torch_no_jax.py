"""The port imports torch and never JAX, and nothing of the JAX package: an
AST scan of every module of multimodal_gar_tpu_torch and of chip_smoke.py,
and a fresh interpreter that imports the whole port and finds neither a JAX
module nor a module of multimodal_gar_tpu loaded."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "multimodal_gar_tpu_torch"
# the port keeps its own copies of the JAX package's framework-neutral
# modules (tests/test_torch_copies.py holds them equal), so the package
# itself is as forbidden as JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodal_gar_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_scan_sees_the_port():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"models/mgar.py", "ops/kernels/stem_conv.py",
            "ops/kernels/window_conv.py", "convert.py", "config.py",
            "data/rulebook.py", "native/__init__.py"} <= names
    # the detector zoo's first slice
    assert {"ops/boxes3d.py", "train/loss_lib.py", "data/detbatch.py",
            "data/kitti.py", "data/processor.py", "data/augmentor.py",
            "eval/kitti_eval.py"} | {
        f"detection/{m}.py" for m in (
            "anchors", "box_coders", "target_assign", "vfe", "bev",
            "dense_heads", "post", "detectors", "roi_heads",
            "roi_detectors", "train", "convert")} <= names
    # and its second slice
    assert {"ops/sampling.py", "ops/neighbor.py", "ops/vector_pool.py"} | {
        f"detection/{m}.py" for m in (
            "point_heads", "pfe", "sparse_backbones", "parta2", "pointnet2",
            "point_rcnn", "voxelnext", "pv_rcnn_pp")} <= names
    # and the rest of the model side: CaDDN with its DeepLab DDN, MPPNet,
    # the extras and the 2D image backbones
    assert {"models/backbones2d.py"} | {
        f"detection/{m}.py" for m in (
            "caddn", "ddn_deeplab", "mppnet", "extras")} <= names
    # the dataset side: the registry, the builders, the adapters and their
    # eval suites, the kernels' padded input layer
    assert {"ops/kernels/_pad.py"} | {f"data/{m}.py" for m in (
        "registry", "builders", "nuscenes", "waymo", "lyft", "once",
        "pandaset", "argo2", "custom")} | {f"eval/{m}_eval.py" for m in (
            "nuscenes", "waymo", "lyft", "once", "argo2")} <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pathlib\n"
        f"root = pathlib.Path({str(PORT)!r})\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    mod = '.'.join(p.relative_to(root.parent).with_suffix('')"
        ".parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
