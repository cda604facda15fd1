"""Nothing the benchmark loads is jax, jaxlib, flax or the JAX package,
by top-level name compared whole: its modules, metric readers, scene kinds
and the reference of every configuration."""

import os
import subprocess
import sys

from hrbench import run as hr

ROOT = hr.ROOT

_WALK = r"""
import importlib, json, os, sys, pkgutil
import hrbench
from hrbench import run as hr
for m in pkgutil.iter_modules(hrbench.__path__):
    if not m.name.startswith(("test_", "conftest")):
        importlib.import_module("hrbench." + m.name)
for f in sorted(os.listdir(os.path.join(hr.HERE, "metrics"))):
    if f.endswith(".py"):
        hr.reader(f[:-3])
# every scene kind, and the reference each configuration names
for f in sorted(os.listdir(os.path.join(hr.HERE, "scenes"))):
    if f.endswith(".py"):
        hr.scene_kind(f[:-3])
man = hr.load_manifest()
for c in man["configs"]:
    conf = json.load(open(os.path.join(hr.ROOT, c["file"])))
    hr.scene_kind(conf["scene"]["kind"])
    hr.reference_of(conf.get("reference", "ref_path"))
# the port's modules that a run imports
import hobbyrenderer_tpu_torch.config, hobbyrenderer_tpu_torch.renderer
import hobbyrenderer_tpu_torch.ops.envmap, hobbyrenderer_tpu_torch.scene.procedural
import hobbyrenderer_tpu_torch.utils.timing
print("FOUND", hr.forbidden_modules())
"""


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout, res.stdout[-2000:]


def test_names_are_compared_whole(monkeypatch):
    for name in ("hobbyrenderer_tpu_torch", "hobbyrenderer_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(hr.forbidden_modules()) & {"hobbyrenderer_tpu_torch",
                                               "hobbyrenderer_tpu_torch.ops", "jaxtyping",
                                               "flaxen"}
    monkeypatch.setitem(sys.modules, "hobbyrenderer_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = hr.forbidden_modules()
    assert "hobbyrenderer_tpu.ops" in found and "jax.numpy" in found
    assert "hobbyrenderer_tpu_torch.ops" not in found and "jaxtyping" not in found
