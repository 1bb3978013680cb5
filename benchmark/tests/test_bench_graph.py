"""The decode graph's build is deterministic: two interpreters with
different hash seeds build the same arrays."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from benchmark.graph import build
spec = dict(units=71, vocab=150, min_word_phones=2, max_word_phones=6,
            lexicon_seed=7, text_seed=11, lm_seed=13, lm_sentences=1500,
            lm_order=3, min_counts=[1, 2, 2], max_degree=16)
build.build_into(spec, {out!r})
"""


def _digest(d):
    h = hashlib.sha256()
    z = np.load(os.path.join(d, "tlg.npz"))
    for k in sorted(z.files):
        h.update(k.encode() + np.ascontiguousarray(z[k]).tobytes())
    h.update(np.load(os.path.join(d, "prons.npy")).tobytes())
    return h.hexdigest()


def test_build_is_deterministic_across_hash_seeds(tmp_path):
    digests = []
    for hs in ("0", "12345"):
        out = tmp_path / hs
        out.mkdir()
        env = dict(os.environ, PYTHONHASHSEED=hs)
        subprocess.run([sys.executable, "-c",
                        SCRIPT.format(root=ROOT, out=str(out))],
                       check=True, env=env, timeout=600)
        digests.append(_digest(str(out)))
    assert digests[0] == digests[1]


def test_cache_key_follows_the_configuration(tmp_path):
    from benchmark.graph import build
    a = tmp_path / "a.json"
    a.write_text('{"name": "x"}')
    k1 = build.cache_key(str(a))
    a.write_text('{"name": "y"}')
    assert build.cache_key(str(a)) != k1


def test_the_graph_library_is_required(tmp_path, monkeypatch):
    from benchmark.graph import fst_native

    def fail(*args, **kw):
        raise subprocess.CalledProcessError(1, args[0], stderr=b"no g++")

    monkeypatch.setattr(fst_native, "_LIB_PATH",
                        str(tmp_path / "libfstlib.so"))
    monkeypatch.setattr(fst_native, "_lib", None)
    monkeypatch.setattr(fst_native.subprocess, "run", fail)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        fst_native._get_lib()
