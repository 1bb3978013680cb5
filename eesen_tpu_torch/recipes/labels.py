"""Transcript -> CTC label-id sequences.

Mirrors the reference's utils/prep_ctc_trans.py: each word maps to its
unit-id sequence via a numbered lexicon; OOVs map to the <UNK> entry; the
character recipes insert a space word between words.  lexicon_numbers.txt
(word -> unit ids) comes from the lang-dir build
(utils/ctc_compile_dict_token.sh copies it from the dict dir).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from eesen_tpu_torch.decoder.ctc_graph import SymbolTable


def lexicon_numbers(
    lexicon: Sequence[Tuple[str, Tuple[str, ...]]], tokens: SymbolTable
) -> Dict[str, List[int]]:
    """word -> unit id sequence (ids from tokens.txt, so blank=1 offset
    applies: unit ids start at 2 in the token table, but the label ids fed
    to CTC are token_id - 1, making blank 0)."""
    out: Dict[str, List[int]] = {}
    for word, phones in lexicon:
        out.setdefault(word, [tokens[p] - 1 for p in phones])
    return out


def prep_ctc_trans(
    lex_num: Dict[str, List[int]],
    text: Dict[str, List[str]],
    unk_word: str = "<UNK>",
    space_word: str = "",
) -> Dict[str, np.ndarray]:
    """text: {utt: [words...]} -> {utt: int32 label ids}."""
    out: Dict[str, np.ndarray] = {}
    unk = lex_num.get(unk_word, [])
    for utt, words in text.items():
        seq: List[int] = []
        toks: List[str] = []
        for i, w in enumerate(words):
            if space_word and i > 0:
                toks.append(space_word)
            toks.append(w)
        for w in toks:
            seq.extend(lex_num.get(w, unk))
        out[utt] = np.asarray(seq, dtype=np.int32)
    return out
