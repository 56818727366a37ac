"""Host-side P2P preprocessing: token alignment, time-word alphas, equalizers
(own copy of ``hedit_tpu/control/p2p_prep.py``).

These run once per sample on the host (NumPy) and produce the fixed-shape
arrays of ``control/p2p.py:P2PControl``.

Behaviour parity:
* Needleman-Wunsch global alignment + refinement / replacement mappers:
  the reference's ``p2p/seq_aligner.py:58-199`` (gap=0, match=1, mismatch=-1,
  traceback preferring left > up > diag on ties exactly as the reference's
  if/elif chain);
* ``get_word_inds`` / ``get_time_words_attention_alpha``:
  the reference's ``p2p/ptp_utils.py:297-355``;
* ``get_equalizer``: ``p2p/ptp_controller_utils.py:92-104``.

* the demo CLI's blend-word / equalizer heuristic (difflib word diff),
  ``preprocess_blend_and_eq``: ``p2p/ptp_controller_utils.py:13-90``.  Words
  come from nltk's punkt tokenizer where nltk and its data are installed, else
  from the regex that JAX's copy falls back on; this copy also takes the regex
  where nltk itself is missing (JAX's catches only the missing data), so the
  CLI runs where there is no nltk.

The JAX package's optional native aligner is not carried over: the alignment
here is the NumPy one, with the same tie-break order.
"""

from __future__ import annotations

import difflib
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_LEN = 77


# ---------------------------------------------------------------- alignment #

def _global_align(x: Sequence[int], y: Sequence[int], gap=0, match=1, mismatch=-1):
    nx, ny = len(x), len(y)
    m = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    m[0, 1:] = (np.arange(ny) + 1) * gap
    m[1:, 0] = (np.arange(nx) + 1) * gap
    tb = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    tb[0, 1:] = 1
    tb[1:, 0] = 2
    tb[0, 0] = 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left = m[i, j - 1] + gap
            up = m[i - 1, j] + gap
            diag = m[i - 1, j - 1] + (match if x[i - 1] == y[j - 1] else mismatch)
            best = max(left, up, diag)
            m[i, j] = best
            # tie-break order matches the reference if/elif chain
            if best == left:
                tb[i, j] = 1
            elif best == up:
                tb[i, j] = 2
            else:
                tb[i, j] = 3
    return tb


def _aligned_mapper(x, y, tb) -> np.ndarray:
    i, j = len(x), len(y)
    mapper_y_to_x = []
    while i > 0 or j > 0:
        if tb[i, j] == 3:
            i, j = i - 1, j - 1
            mapper_y_to_x.append((j, i))
        elif tb[i, j] == 1:
            j -= 1
            mapper_y_to_x.append((j, -1))
        elif tb[i, j] == 2:
            i -= 1
        else:
            break
    mapper_y_to_x.reverse()
    return np.asarray(mapper_y_to_x, dtype=np.int64)


def _encode_with_specials(tokenizer, text: str) -> List[int]:
    return [tokenizer.sot_id] + tokenizer.encode(text) + [tokenizer.eot_id]


def get_mapper(x: str, y: str, tokenizer, max_len: int = MAX_LEN):
    """-> (mapper [77] int64, alphas [77] float32), ``seq_aligner.py:112-123``."""
    x_seq = _encode_with_specials(tokenizer, x)
    y_seq = _encode_with_specials(tokenizer, y)
    base = _aligned_mapper(x_seq, y_seq, _global_align(x_seq, y_seq))
    alphas = np.ones(max_len, dtype=np.float32)
    alphas[: base.shape[0]] = (base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, dtype=np.int64)
    mapper[: base.shape[0]] = base[:, 1]
    mapper[base.shape[0] :] = len(y_seq) + np.arange(max_len - len(y_seq))
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer, max_len: int = MAX_LEN):
    mappers, alphas = [], []
    for i in range(1, len(prompts)):
        m, a = get_mapper(prompts[0], prompts[i], tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices (1-based past SOT) of a word in the prompt
    (``ptp_utils.py:297-315``)."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, w in enumerate(split_text) if word_place == w]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        ids = _encode_with_specials(tokenizer, text)[1:-1]
        words_encode = [tokenizer.decode([i]).strip().strip("#") for i in ids]
        cur_len, ptr = 0, 0
        for i, w in enumerate(words_encode):
            cur_len += len(w)
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, dtype=np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = MAX_LEN):
    words_x, words_y = x.split(" "), y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit requires same-length prompts "
            f"({len(words_x)} vs {len(words_y)} words)"
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and len(inds_source[cur]) and inds_source[cur][0] == i:
            s, t = inds_source[cur], inds_target[cur]
            if len(s) == len(t):
                mapper[s, t] = 1
            else:
                ratio = 1 / len(t)
                for tt in t:
                    mapper[s, tt] = ratio
            cur += 1
            i += len(s)
            j += len(t)
        elif cur < len(inds_source):
            mapper[i, j] = 1
            i += 1
            j += 1
        else:
            mapper[j, j] = 1
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer, max_len: int = MAX_LEN):
    return np.stack(
        [get_replacement_mapper_(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    )


# -------------------------------------------------------------- time alphas #

def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps,
    tokenizer,
    max_num_words: int = MAX_LEN,
) -> np.ndarray:
    """-> [num_steps + 1, n_edits, max_words] float32 (``ptp_utils.py:331-355``)."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    n_edits = len(prompts) - 1
    alpha = np.zeros((num_steps + 1, n_edits, max_num_words), dtype=np.float32)

    def update(bounds, prompt_ind, word_inds=None):
        if isinstance(bounds, float):
            bounds = (0.0, bounds)
        start = int(bounds[0] * alpha.shape[0])
        end = int(bounds[1] * alpha.shape[0])
        wi = np.arange(max_num_words) if word_inds is None else word_inds
        alpha[:start, prompt_ind, wi] = 0
        alpha[start:end, prompt_ind, wi] = 1
        alpha[end:, prompt_ind, wi] = 0

    for i in range(n_edits):
        update(cross_replace_steps["default_"], i)
    for key, item in cross_replace_steps.items():
        if key != "default_":
            for i in range(n_edits):
                inds = get_word_inds(prompts[i + 1], key, tokenizer)
                if len(inds) > 0:
                    update(item, i, inds)
    return alpha


# ---------------------------------------------------------------- equalizer #

def get_equalizer(
    text: str, words: Sequence[str], values: Sequence[float], tokenizer
) -> np.ndarray:
    """[77] multiplier (``ptp_controller_utils.py:92-104`` — per-word values)."""
    eq = np.ones(MAX_LEN, dtype=np.float32)
    for word, val in zip(words, values):
        inds = get_word_inds(text, word, tokenizer)
        eq[inds] = val
    return eq


# ------------------------------------------------------- blend-word heuristic #

def _word_tokenize(text: str) -> List[str]:
    try:
        from nltk.tokenize import word_tokenize

        return word_tokenize(text)
    except (ImportError, LookupError):  # no nltk, or no punkt data
        return re.findall(r"\w+|[^\w\s]", text)


def preprocess_blend_and_eq(
    src_prompt: str,
    tar_prompt: str,
    *,
    eq_value: float = 1.5,
    is_global_edit: bool = True,
) -> Tuple[Optional[Tuple], Optional[Dict]]:
    """difflib word-diff heuristic -> (blend_word, eq_params)
    (``ptp_controller_utils.py:13-52``; eq_value 1.25 variant at :54-90)."""
    src_words = _word_tokenize(src_prompt)
    trg_words = _word_tokenize(tar_prompt)
    matcher = difflib.SequenceMatcher(None, src_words, trg_words)
    src_text, trg_text = [], []
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "replace":
            src_text.extend(src_words[i1:i2])
            trg_text.extend(trg_words[j1:j2])
        elif tag == "insert":
            trg_text.extend(trg_words[j1:j2])
        elif tag == "delete":
            src_text.extend(src_words[i1:i2])
    src_text, trg_text = " ".join(src_text), " ".join(trg_text)

    if len(src_text) == 0 or len(trg_text) == 0 or not is_global_edit:
        blend_word = None
    else:
        blend_word = ((src_text,), (trg_text,))
    words_to_focus = trg_text.split()
    eq_params = (
        {"words": tuple(words_to_focus), "values": tuple(eq_value for _ in words_to_focus)}
        if words_to_focus
        else None
    )
    return blend_word, eq_params
