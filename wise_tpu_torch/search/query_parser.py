"""Audiovisual search query grammar parser.

Grammar (reference: docs/Grammar-of-Audiovisual-Search.md, implementation
contract pinned by ox-vgg/WISE/src/search/test_query_parser.py):

    <search>   := <unit> ( (AND|OR) <unit> )*
    <unit>     := <compound> (IN | NOT IN) <target>
    <compound> := <item> ( (+|-) <item> )*
    <item>     := bare words | "quoted phrase" | @filename
    <target>   := audio | video | image | metadata   (case-insensitive)

Returns ``(status, tree)`` where tree is::

    {"cmd": <original>,
     "query": [{"query_str": [...], "query_type": ["text"|"file", ...],
                "query_embedding_vec_op": ["+"|"-", ...],
                "search_target": str, "search_target_link": "in"|"not in"}],
     "query_result_merge_ops": ["and"|"or", ...]}

Copy of ``wise_tpu/search/query_parser.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_TARGETS = {"audio", "video", "image", "metadata"}


def _tokenize(cmd: str) -> List[Tuple[str, str]]:
    """Tokens: ('quoted', '"..."'), ('file', 'name'), ('op', '+'|'-'),
    ('word', text)."""
    tokens: List[Tuple[str, str]] = []
    i, n = 0, len(cmd)
    while i < n:
        c = cmd[i]
        if c.isspace():
            i += 1
            continue
        if c == '"':
            j = cmd.find('"', i + 1)
            if j < 0:
                return []  # unbalanced quote
            tokens.append(("quoted", cmd[i : j + 1]))
            i = j + 1
        elif c in "+-" and (i + 1 >= n or cmd[i + 1].isspace()):
            tokens.append(("op", c))
            i += 1
        elif c == "@":
            j = i + 1
            while j < n and not cmd[j].isspace():
                j += 1
            tokens.append(("file", cmd[i + 1 : j]))
            i = j
        else:
            j = i
            while j < n and not cmd[j].isspace():
                j += 1
            tokens.append(("word", cmd[i:j]))
            i = j
    return tokens


def _parse_unit(tokens: List[Tuple[str, str]]) -> Dict:
    if len(tokens) < 2:
        raise ValueError("incomplete query unit")
    # trailing: [NOT] IN <target>
    kind, target = tokens[-1]
    if kind != "word" or target.lower() not in _TARGETS:
        raise ValueError(f"unknown search target {target!r}")
    if len(tokens) >= 2 and tokens[-2] == ("word", "in") or (
        tokens[-2][0] == "word" and tokens[-2][1].lower() == "in"
    ):
        if (
            len(tokens) >= 3
            and tokens[-3][0] == "word"
            and tokens[-3][1].lower() == "not"
        ):
            link, body = "not in", tokens[:-3]
        else:
            link, body = "in", tokens[:-2]
    else:
        raise ValueError("query unit must end with IN/NOT IN <target>")

    query_str: List[str] = []
    query_type: List[str] = []
    vec_ops: List[str] = []
    pending_words: List[str] = []

    def flush_words():
        if pending_words:
            query_str.append(" ".join(pending_words))
            query_type.append("text")
            pending_words.clear()

    for kind, val in body:
        if kind == "word":
            pending_words.append(val)
        elif kind == "quoted":
            flush_words()
            query_str.append(val)
            query_type.append("text")
        elif kind == "file":
            flush_words()
            query_str.append(val)
            query_type.append("file")
        elif kind == "op":
            flush_words()
            vec_ops.append(val)
    flush_words()

    if not query_str:
        raise ValueError("empty query")
    if len(vec_ops) != len(query_str) - 1:
        raise ValueError("malformed +/- compound query")
    return {
        "query_str": query_str,
        "query_type": query_type,
        "query_embedding_vec_op": vec_ops,
        "search_target": target.lower(),
        "search_target_link": link,
    }


def parse_search_query(cmd: str):
    tokens = _tokenize(cmd)
    if not tokens:
        return {"status": "ERROR", "message": "empty or malformed query"}, {}
    units: List[List[Tuple[str, str]]] = [[]]
    merge_ops: List[str] = []
    for kind, val in tokens:
        if kind == "word" and val.lower() in ("and", "or"):
            merge_ops.append(val.lower())
            units.append([])
        else:
            units[-1].append((kind, val))
    try:
        parsed = [_parse_unit(u) for u in units]
    except ValueError as e:
        return {"status": "ERROR", "message": str(e)}, {}
    return (
        {"status": "OK"},
        {"cmd": cmd, "query": parsed, "query_result_merge_ops": merge_ops},
    )
