"""The decode cells' graph: a TLG of a pruned trigram over a synthetic
lexicon, built once per checkout and cached.

The build is the stress recipe's (eesen_tpu_torch/examples/
stress_recipe.py): lexicon, text process, `estimate_ngram_arpa`,
`arpa_to_fst`, `build_full_compiled`, all from the frozen copies beside
this file, so that a change to the port cannot move the graph.  The
configuration's `decode_graph` group sets every size and seed.

The cache lives in benchmark/_cache/<config>-<key>/, keyed by the
configuration file's bytes and the sources of this folder.  A build is
written into a private directory and renamed into place, so that a run
never reads half a graph.  The directory holds

- tlg.npz: the compiled graph (`CompiledGraph.save`), which the port
  loads with its own `CompiledGraph.load`;
- prons.npy: [words, max phones] int32 token ids of each word's pron
  (-1 padded), rows in the lexicon's order (the text process's word
  ids), for the decode traffic;
- meta.json: the graph's counts and the build's seconds.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CACHE = os.path.join(BENCH, "_cache")


def cache_key(cfg_path: str) -> str:
    h = hashlib.sha256()
    with open(cfg_path, "rb") as f:
        h.update(f.read())
    for name in sorted(os.listdir(HERE)):
        if name.endswith((".py", ".cpp")):
            with open(os.path.join(HERE, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_into(spec: dict, out_dir: str) -> dict:
    """Build the graph of `spec` (a `decode_graph` group) into out_dir."""
    from benchmark.graph.arpa import arpa_to_fst
    from benchmark.graph.ctc_graph import build_full_compiled, compile_lang
    from benchmark.graph.lm import estimate_ngram_arpa
    from benchmark.graph.text import (
        build_text_process, make_lexicon, sample_sentences,
    )

    t0 = time.perf_counter()
    units = [f"p{i:02d}" for i in range(spec["units"])]
    lex = make_lexicon(spec["vocab"], spec["units"], spec["min_word_phones"],
                       spec["max_word_phones"],
                       np.random.default_rng(spec["lexicon_seed"]))
    words = [w for w, _ in lex]
    succ, slot_p = build_text_process(
        spec["vocab"], np.random.default_rng(spec["text_seed"]))
    sents = sample_sentences(
        spec["lm_sentences"], succ, slot_p, spec["vocab"],
        np.random.default_rng(spec["lm_seed"]))
    arpa = estimate_ngram_arpa(
        [[words[int(j)] for j in s] for s in sents],
        order=spec["lm_order"], vocab=words,
        min_counts=tuple(spec["min_counts"]),
    )
    t_lm = time.perf_counter()
    lang = compile_lang(lex, units, dict_type="phn")
    g_fst = arpa_to_fst(arpa, lang.words)
    t_g = time.perf_counter()
    graph = build_full_compiled(
        lang.t_fst, lang.l_fst, g_fst, max_degree=spec["max_degree"],
        build_closure=True,
    )
    t_tlg = time.perf_counter()
    graph.save(os.path.join(out_dir, "tlg.npz"))
    max_pron = spec["max_word_phones"]
    prons = np.full((len(lex), max_pron), -1, np.int32)
    for r, (_, pron) in enumerate(lex):
        for c, u in enumerate(pron):
            prons[r, c] = lang.tokens[u]
    np.save(os.path.join(out_dir, "prons.npy"), prons)
    meta = {
        "states": int(graph.num_states),
        "emit_arcs": int(graph.num_emit_arcs),
        "eps_arcs": int(graph.num_eps_arcs),
        "closure_arcs": int(len(graph.closure_packed)),
        "max_emit_degree": int(graph.max_emit_degree),
        "max_closure_degree": int(graph.max_closure_degree),
        "g_states": int(g_fst.num_states),
        "g_arcs": int(g_fst.num_arcs),
        "arpa_lines": len(arpa.splitlines()),
        "seconds": {"lm": t_lm - t0, "g": t_g - t_lm, "tlg": t_tlg - t_g},
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def ensure(cfg: dict, cfg_path: str) -> str:
    """The cache directory of `cfg`'s graph, built first if absent."""
    final = os.path.join(CACHE, f"{cfg['name']}-{cache_key(cfg_path)}")
    if os.path.exists(os.path.join(final, "meta.json")):
        return final
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    build_into(cfg["decode_graph"], tmp)
    try:
        os.replace(tmp, final)
    except OSError:
        # another process renamed its build into place first
        shutil.rmtree(tmp, ignore_errors=True)
    return final
