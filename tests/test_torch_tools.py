"""The port's tools (`okvis2x_tpu_torch/tools/`) against the JAX package's
`tools/`: `bag_creator` on EuRoC-layout folders of grey, 16-bit grey and
colour PNGs (the bags equal byte for byte: the port's codec turns colour
grey as Pillow's ``convert("L")`` does); `hilti_bag2mrl` and `vbr_bag2mrl`
on tests/test_rosbag.py's small bags (the same folder trees, the CSVs byte
for byte, the PNGs as decoded pixels, the same report); `evaluate_ate` on
tests/test_evaluate_ate.py's trajectories (the same JSON and exit codes)."""

import csv
import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from okvis2x_tpu_torch.io import png, trajectory_io
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.tools import bag_creator, evaluate_ate, hilti_bag2mrl, vbr_bag2mrl
from test_evaluate_ate import _traj
from test_torch_rosbag import hilti_bag, vbr_bag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX package's tools/ modules by name."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return {n: importlib.import_module(n)
                for n in ("bag_creator", "hilti_bag2mrl", "vbr_bag2mrl", "evaluate_ate")}
    finally:
        sys.path.pop(0)


def run_jax_main(tool, argv, monkeypatch):
    """A JAX tool's `main()`, which reads sys.argv."""
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [tool.__file__, *argv])
        return tool.main()


def colour_folder(root, rng):
    """An EuRoC-layout folder with RGB, RGBA and grey-and-alpha PNGs in two
    cameras and an IMU CSV."""
    modes = {"RGB": 3, "RGBA": 4, "LA": 2}
    for c in range(2):
        d = os.path.join(root, f"cam{c}", "data")
        os.makedirs(d)
        for k, (mode, ch) in enumerate(modes.items()):
            arr = rng.integers(0, 256, (24, 31, ch), dtype=np.uint8)
            Image.fromarray(arr, mode=mode).save(os.path.join(d, f"{1000 + 50 * k + c}.png"))
    os.makedirs(os.path.join(root, "imu0"))
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        w = csv.writer(f)
        w.writerow(["#timestamp", "wx", "wy", "wz", "ax", "ay", "az"])
        for k in range(7):
            w.writerow([990 + 25 * k, *rng.normal(0, 1, 6)])


def grey16_folder(root, rng):
    """One camera of 16-bit grey PNGs (Pillow's convert("L") clips them)."""
    d = os.path.join(root, "cam0", "data")
    os.makedirs(d)
    for k in range(3):
        arr = rng.integers(0, 600, (10, 13), dtype=np.uint16)
        png.write(os.path.join(d, f"{2000 + k}.png"), arr)


@pytest.mark.parametrize("kind", ["grey", "grey16", "colour"])
def test_bag_creator_matches_jax(tmp_path, kind, jax_tools, monkeypatch, capsys):
    rng = np.random.default_rng(len(kind))
    folder = str(tmp_path / "ds")
    if kind == "grey":
        synthetic.generate(folder, duration=0.5, frame_rate=10.0, width=48, height=36,
                           n_points=40)
        folder = os.path.join(folder, "mav0")
    elif kind == "grey16":
        grey16_folder(folder, rng)
    else:
        colour_folder(folder, rng)
    bags = {k: str(tmp_path / f"{k}.bag") for k in ("jax", "port")}
    run_jax_main(jax_tools["bag_creator"], ["--folder", folder, "--output-bag", bags["jax"]],
                 monkeypatch)
    said_jax = capsys.readouterr().out.replace(bags["jax"], "BAG")
    bag_creator.main(["--folder", folder, "--output-bag", bags["port"]])
    said_port = capsys.readouterr().out.replace(bags["port"], "BAG")
    assert said_port == said_jax and " 0 images" not in said_port
    with open(bags["jax"], "rb") as a, open(bags["port"], "rb") as b:
        assert a.read() == b.read()


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["hilti", "vbr"])
def test_bag2mrl_matches_jax(tmp_path, name, jax_tools, monkeypatch, capsys):
    src = str(tmp_path / "in.bag")
    (hilti_bag if name == "hilti" else vbr_bag)(src)
    bags = {}
    for k in ("jax", "port"):
        os.makedirs(tmp_path / k)
        bags[k] = str(tmp_path / k / "seq.bag")
        shutil.copy(src, bags[k])
    tool = f"{name}_bag2mrl"
    run_jax_main(jax_tools[tool], [bags["jax"]], monkeypatch)
    said_jax = capsys.readouterr().out.replace(str(tmp_path / "jax"), "DIR")
    {"hilti": hilti_bag2mrl, "vbr": vbr_bag2mrl}[name].main([bags["port"]])
    said_port = capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR")
    assert said_port == said_jax and "images: 0" not in said_port
    outs = {k: str(tmp_path / k / "seq") for k in bags}
    assert tree(outs["port"]) == tree(outs["jax"]) and tree(outs["port"])
    for rel in tree(outs["port"]):
        a, b = (os.path.join(outs[k], rel) for k in ("jax", "port"))
        if rel.endswith(".png"):
            np.testing.assert_array_equal(png.read(a), png.read(b))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_bag2mrl_without_bags(jax_tools, monkeypatch):
    for tool, port in (("hilti_bag2mrl", hilti_bag2mrl), ("vbr_bag2mrl", vbr_bag2mrl)):
        for main in (lambda: run_jax_main(jax_tools[tool], [], monkeypatch),
                     lambda: port.main([])):
            with pytest.raises(SystemExit, match="No bag files provided"):
                main()


def test_evaluate_ate_matches_jax(tmp_path, jax_tools, capsys):
    """tests/test_evaluate_ate.py's gate through both tools: the same JSON
    and exit codes (0 within the bound, 1 beyond it, 2 with too few
    associated poses), with and without the Sim(3) alignment."""
    t, T = _traj()
    _, Td = _traj(drift=0.05)
    a, b, c = (str(tmp_path / n) for n in ("est.tum", "gt.tum", "far.tum"))
    trajectory_io.write_tum(a, t, Td)
    trajectory_io.write_tum(b, t, T)
    trajectory_io.write_tum(c, t + 100.0, T)  # no stamp associates
    cases = [([a, b], 0), ([a, b, "--bound", "1e-6"], 1), ([a, b, "--bound", "10.0"], 0),
             ([a, b, "--scale", "--rpe-delta", "3", "--max-dt", "0.05"], 0), ([c, b], 2)]
    for argv, rc in cases:
        outs = []
        for main in (jax_tools["evaluate_ate"].main, evaluate_ate.main):
            assert main(argv) == rc, argv
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1], argv
