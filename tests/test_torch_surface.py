"""The port's package surface against the JAX package's: every name a JAX
subpackage exports (`__all__`) imports from the port's subpackage of the
same name, the package has a version, importing builds no kernel, and the
beam search takes every JAX search option but the kernel switch."""

import dataclasses
import importlib
import os
import subprocess
import sys
import textwrap

import pytest

import eesen_tpu
import eesen_tpu_torch
from eesen_tpu.decoder import beam as jbeam
from eesen_tpu_torch.decoder import beam as tbeam

SUBPACKAGES = ("decoder", "frontend", "io", "models", "ops", "parallel",
               "recipes", "training", "utils")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    jax_pkg = importlib.import_module(f"eesen_tpu.{sub}")
    port = importlib.import_module(f"eesen_tpu_torch.{sub}")
    missing = [n for n in jax_pkg.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(jax_pkg.__all__) <= set(port.__all__)
    for name in port.__all__:
        obj = getattr(port, name)
        mod = getattr(obj, "__module__", None) or ""
        assert not mod.startswith("eesen_tpu."), (name, mod)


def test_version():
    assert eesen_tpu_torch.__version__ == eesen_tpu.__version__


def test_importing_builds_no_kernel(tmp_path):
    """Every subpackage, and the decoder down to the kernel wrappers,
    imported in a fresh interpreter whose nvcc (CUDA_HOME) only leaves a
    mark: no mark, and no kernel library loaded."""
    mark = tmp_path / "nvcc_ran"
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    fake.chmod(0o755)
    code = textwrap.dedent(f"""
        import importlib
        for sub in {SUBPACKAGES!r}:
            importlib.import_module("eesen_tpu_torch." + sub)
        from eesen_tpu_torch.decoder import make_beam_decoder
        from eesen_tpu_torch.ops import beam_cuda, build, lstm_cuda
        assert build._lib is None, build._lib
        print("ok")
    """)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
    assert not mark.exists()


def test_beam_config_fields_are_the_jax_fields():
    """Every field of the JAX search config but pallas_dedup, the switch
    of a kernel the port always takes where it fits."""
    jf = {f.name for f in dataclasses.fields(jbeam.BeamSearchConfig)}
    tf = {f.name for f in dataclasses.fields(tbeam.BeamSearchConfig)}
    assert tf == jf - {"pallas_dedup"}
    # and a JAX config's settings build the port's
    jcfg = jbeam.BeamSearchConfig(approx_top_k=True, light_emit_dedup=True,
                                  acoustic_gather=True, scan_unroll=4,
                                  arc_budget_emit=64, arc_budget_x=64)
    kw = {n: getattr(jcfg, n) for n in tf}
    assert dataclasses.asdict(tbeam.BeamSearchConfig(**kw)) == kw
