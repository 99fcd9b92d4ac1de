"""Guided decoding: structured output compiled to token-level FSMs.

The port's own copy of `dynamo_tpu/llm/guided.py` (pure Python and numpy;
the port imports nothing of the JAX package). It covers the OpenAI
`response_format` (json_object / json_schema) and the nvext fields
`guided_choice` / `guided_regex` / `guided_json`:

  host side    regex / JSON schema -> char DFA -> token-level mask, one
               FSM state per request lane, advanced as tokens are emitted;
  device side  the lane's vocabulary bitmask rides the guided prefill,
               decode and mixed dispatches (engine/engine.py) and is applied
               to the logits inside the sampler (engine/sampling.py
               `mask=`), so no logits travel to the host.

The mask for step t+1 depends on the token emitted at step t, so a guided
lane forces single-step, non-pipelined decode dispatches while it decodes
(`TorchEngine._dispatch_decode`); the unguided lanes batched with it decode
one token a dispatch for that window.

JSON-schema support is the practical subset (type string/integer/number/
boolean/null, const, enum, object properties — all treated as required,
in declaration order — arrays with bounded item counts, bounded nesting
depth). `json_object` mode accepts any JSON value to a bounded depth. The
vocabulary comes from the served tokenizer (`llm/tokenizers.py`:
`ByteTokenizer` or `GgufTokenizer`), through `vocab_strings`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------- #
# regex AST + parser (the subset the schema compiler emits, plus user
# guided_regex patterns: literals, escapes, classes, quantifiers,
# groups, alternation; fullmatch semantics, no anchors/backrefs)
# --------------------------------------------------------------------- #

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_SPACE = frozenset(" \t\n\r\f\v")

_META = set(r"\.[](){}*+?|^$")
MAX_REPEAT = 4096  # cap on {m,n} expansion (DoS guard; see _repeat)


@dataclass(frozen=True)
class CharSet:
    """A character class: `negated=False` matches chars ∈ `chars`;
    `negated=True` matches chars ∉ `chars` (the dot is `chars={'\\n'},
    negated=True`)."""

    chars: FrozenSet[str]
    negated: bool = False

    def matches(self, ch: str) -> bool:
        return (ch in self.chars) != self.negated


def _esc_literal(text: str) -> str:
    """Escape regex metacharacters so `text` matches itself."""
    return "".join("\\" + c if c in _META else c for c in text)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alt(self):
        branches = [self._concat()]
        while self.peek() == "|":
            self.next()
            branches.append(self._concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def _concat(self):
        items = []
        while self.peek() is not None and self.peek() not in "|)":
            items.append(self._repeat())
        if not items:
            return ("cat", [])  # empty branch (matches "")
        return ("cat", items) if len(items) > 1 else items[0]

    def _repeat(self):
        node = self._atom()
        ch = self.peek()
        if ch == "*":
            self.next()
            return ("star", node)
        if ch == "+":
            self.next()
            return ("cat", [node, ("star", node)])
        if ch == "?":
            self.next()
            return ("alt", [node, ("cat", [])])
        if ch == "{":
            save = self.i
            self.next()
            spec = ""
            while self.peek() is not None and self.peek() != "}":
                spec += self.next()
            if self.peek() != "}" or not spec or not spec.replace(",", "").isdigit():
                # not a quantifier (e.g. a literal '{' in a schema string
                # would have been escaped; treat malformed as error)
                self.i = save
                raise ValueError(f"bad quantifier at {save} in {self.p!r}")
            self.next()
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(spec)
            if lo > MAX_REPEAT or (hi or 0) > MAX_REPEAT:
                # quantifiers expand to lo+hi AST nodes BEFORE the DFA
                # max_states guard can fire: a {0,300000} would pin the
                # compile thread / OOM long before subset construction
                raise ValueError(
                    f"repetition bound exceeds {MAX_REPEAT}"
                )
            parts: list = [node] * lo
            if hi is None:
                parts.append(("star", node))
            else:
                if hi < lo:
                    raise ValueError(f"bad range {{{spec}}}")
                opt = ("alt", [node, ("cat", [])])
                parts.extend([opt] * (hi - lo))
            return ("cat", parts)
        return node

    def _atom(self):
        ch = self.next()
        if ch == "(":
            if self.peek() == "?":  # (?: non-capturing — same thing here
                self.next()
                if self.peek() == ":":
                    self.next()
                else:
                    raise ValueError("only (?: groups supported")
            node = self._alt()
            if self.peek() != ")":
                raise ValueError("unbalanced (")
            self.next()
            return node
        if ch == "[":
            return ("lit", self._char_class())
        if ch == ".":
            return ("lit", CharSet(frozenset("\n"), negated=True))
        if ch == "\\":
            return ("lit", self._escape(self.next()))
        if ch in _META:
            raise ValueError(f"unexpected {ch!r} at {self.i - 1}")
        return ("lit", CharSet(frozenset(ch)))

    def _escape(self, ch: str) -> CharSet:
        table = {
            "d": CharSet(_DIGITS),
            "D": CharSet(_DIGITS, negated=True),
            "w": CharSet(_WORD),
            "W": CharSet(_WORD, negated=True),
            "s": CharSet(_SPACE),
            "S": CharSet(_SPACE, negated=True),
            "n": CharSet(frozenset("\n")),
            "t": CharSet(frozenset("\t")),
            "r": CharSet(frozenset("\r")),
        }
        if ch in table:
            return table[ch]
        if ch == "x":  # \xNN hex escape (schema compiler: control chars)
            hx = self.next() + self.next()
            return CharSet(frozenset(chr(int(hx, 16))))
        return CharSet(frozenset(ch))  # \. \\ \[ etc: the literal char

    def _char_class(self) -> CharSet:
        negated = False
        if self.peek() == "^":
            self.next()
            negated = True
        chars: set = set()
        prev: Optional[str] = None
        while True:
            ch = self.peek()
            if ch is None:
                raise ValueError("unbalanced [")
            if ch == "]":
                self.next()
                break
            self.next()
            if ch == "\\":
                sub = self._escape(self.next())
                if sub.negated:
                    raise ValueError("negated escape inside class unsupported")
                chars |= sub.chars
                # single-char escapes (\xNN, \-, \]) can anchor a range
                prev = next(iter(sub.chars)) if len(sub.chars) == 1 else None
                continue
            if ch == "-" and prev is not None and self.peek() not in (None, "]"):
                end = self.next()
                if end == "\\":
                    endset = self._escape(self.next())
                    if len(endset.chars) != 1:
                        raise ValueError("bad range end in class")
                    end = next(iter(endset.chars))
                for o in range(ord(prev), ord(end) + 1):
                    chars.add(chr(o))
                prev = None
                continue
            chars.add(ch)
            prev = ch
        return CharSet(frozenset(chars), negated=negated)


# --------------------------------------------------------------------- #
# NFA (Thompson) → DFA (subset construction)
# --------------------------------------------------------------------- #


class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[CharSet, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, start: int) -> int:
        """Wire `node` from `start`, return its accepting state."""
        kind = node[0]
        if kind == "lit":
            end = self.state()
            self.edges[start].append((node[1], end))
            return end
        if kind == "cat":
            cur = start
            for child in node[1]:
                cur = self.build(child, cur)
            return cur
        if kind == "alt":
            end = self.state()
            for child in node[1]:
                mid = self.state()
                self.eps[start].append(mid)
                sub_end = self.build(child, mid)
                self.eps[sub_end].append(end)
            return end
        if kind == "star":
            loop = self.state()
            end = self.state()
            self.eps[start].append(loop)
            self.eps[start].append(end)
            sub_end = self.build(node[1], loop)
            self.eps[sub_end].append(loop)
            self.eps[sub_end].append(end)
            return end
        raise AssertionError(kind)


@dataclass
class Dfa:
    """Char-level DFA. `trans[s]` holds targets for explicit-alphabet chars
    (absent ⇒ dead); chars outside `sigma` route via `other[s]` (-1 =
    dead) — that's how negated classes/dot admit the unbounded rest of
    unicode without enumerating it."""

    trans: List[Dict[str, int]]
    other: List[int]
    accept: List[bool]
    sigma: FrozenSet[str]

    def step(self, state: int, ch: str) -> int:
        if state < 0:
            return -1
        t = self.trans[state]
        if ch in t:
            return t[ch]
        if ch in self.sigma:
            return -1
        return self.other[state]

    def walk(self, state: int, text: str) -> int:
        for ch in text:
            state = self.step(state, ch)
            if state < 0:
                return -1
        return state

    def fullmatch(self, text: str) -> bool:
        s = self.walk(0, text)
        return s >= 0 and self.accept[s]


def compile_regex(pattern: str, max_states: int = 20000) -> Dfa:
    ast = _Parser(pattern).parse()
    nfa = _Nfa()
    start = nfa.state()
    end = nfa.build(ast, start)

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    sigma = set()
    for edges in nfa.edges:
        for cs, _ in edges:
            sigma |= cs.chars
    sigma = frozenset(sigma)

    start_set = eclose(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    trans: List[Dict[str, int]] = []
    other: List[int] = []
    accept: List[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row: Dict[str, int] = {}
        # explicit chars
        for ch in sigma:
            nxt = set()
            for s in cur:
                for cs, t in nfa.edges[s]:
                    if cs.matches(ch):
                        nxt.add(t)
            if nxt:
                tgt = eclose(frozenset(nxt))
                if tgt not in ids:
                    ids[tgt] = len(order)
                    order.append(tgt)
                    if len(order) > max_states:
                        raise ValueError("pattern too complex (DFA blowup)")
                row[ch] = ids[tgt]
        # the OTHER symbol: any char ∉ sigma (matches only negated sets)
        nxt = set()
        for s in cur:
            for cs, t in nfa.edges[s]:
                if cs.negated:
                    nxt.add(t)
        o = -1
        if nxt:
            tgt = eclose(frozenset(nxt))
            if tgt not in ids:
                ids[tgt] = len(order)
                order.append(tgt)
            o = ids[tgt]
        trans.append(row)
        other.append(o)
        accept.append(end in cur)
    return Dfa(trans=trans, other=other, accept=accept, sigma=sigma)


# --------------------------------------------------------------------- #
# JSON schema / json_object → regex
# --------------------------------------------------------------------- #

_WS = "[ \t\n]*"
# JSON string: no raw control chars; only the legal JSON escapes
_STRING_CHAR = r'([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))'
_STRING = '"' + _STRING_CHAR + '*"'
_INT = "\\-?(0|[1-9][0-9]*)"
_NUM = _INT + "(\\.[0-9]+)?([eE][\\-+]?[0-9]+)?"
_SCALAR = f"({_STRING}|{_NUM}|true|false|null)"

DEFAULT_DEPTH = 4
DEFAULT_MAX_ITEMS = 8


def _free_value(depth: int) -> str:
    """Any JSON value, nesting bounded by `depth` (JSON is context-free;
    a regular approximation must bound the stack)."""
    if depth <= 0:
        return _SCALAR
    v = _free_value(depth - 1)
    obj = (
        "\\{" + _WS
        + f"({_STRING}{_WS}:{_WS}{v}({_WS},{_WS}{_STRING}{_WS}:{_WS}{v})*)?"
        + _WS + "\\}"
    )
    arr = "\\[" + _WS + f"({v}({_WS},{_WS}{v})*)?" + _WS + "\\]"
    return f"({_SCALAR}|{obj}|{arr})"


def schema_to_regex(schema: dict, depth: int = DEFAULT_DEPTH) -> str:
    if not isinstance(schema, dict):
        raise ValueError("schema must be an object")
    if "const" in schema:
        return _esc_literal(json.dumps(schema["const"]))
    if "enum" in schema:
        return (
            "(" + "|".join(_esc_literal(json.dumps(v)) for v in schema["enum"]) + ")"
        )
    for union_key in ("anyOf", "oneOf"):
        if union_key in schema:
            siblings = (
                {"type", "properties", "items", "enum", "const", "required",
                 "minLength", "maxLength", "pattern", "minItems", "maxItems"}
                & set(schema)
            )
            if siblings:
                # intersecting a union with sibling constraints is not
                # supported — enforcing only the union would be WEAKER
                # than the client asked for (silent-accept discipline)
                raise ValueError(
                    f"{union_key} cannot be combined with {sorted(siblings)}"
                )
            subs = schema[union_key]
            if not subs or not isinstance(subs, list):
                raise ValueError(f"{union_key} must be a non-empty list")
            if depth <= 0:
                raise ValueError("schema nesting exceeds supported depth")
            return (
                "("
                + "|".join(schema_to_regex(s, depth - 1) for s in subs)
                + ")"
            )
    t = schema.get("type")
    if isinstance(t, list):
        return (
            "("
            + "|".join(
                schema_to_regex({**schema, "type": x}, depth) for x in t
            )
            + ")"
        )
    if t == "string":
        if "pattern" in schema:
            # a raw pattern spliced between quotes can emit output that is
            # not valid JSON (embedded quotes/backslashes) — reject rather
            # than enforce a broken constraint
            raise ValueError(
                "string `pattern` is not supported in guided json_schema; "
                "use guided_regex for free-form patterns"
            )
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is not None or hi is not None:
            lo = int(lo or 0)
            quant = "{%d,%s}" % (lo, "" if hi is None else int(hi))
            return '"' + _STRING_CHAR + quant + '"'
        return _STRING
    if t == "integer":
        return _INT
    if t == "number":
        return _NUM
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        if depth <= 0:
            raise ValueError("schema nesting exceeds supported depth")
        item = schema_to_regex(schema.get("items", {}), depth - 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max(lo, DEFAULT_MAX_ITEMS)))
        if hi < lo:
            raise ValueError("maxItems < minItems")
        if hi == 0:
            return "\\[" + _WS + "\\]"
        body = item + f"({_WS},{_WS}{item})" + "{%d,%d}" % (
            max(lo - 1, 0), hi - 1
        )
        if lo == 0:
            body = f"({body})?"
        return "\\[" + _WS + body + _WS + "\\]"
    if t == "object":
        props = schema.get("properties")
        if not props:
            return _free_value(max(depth, 1))
        if depth <= 0:
            raise ValueError("schema nesting exceeds supported depth")
        # `required` honored when present; absent = ALL required (stricter
        # than JSON Schema's none-required default, but the right default
        # for structured output — and the pre-round-5 behavior). Optional
        # properties keep declaration order; comma placement rides a
        # first-present-item alternation (an item can open the object only
        # if every earlier item is optional).
        required = (
            set(schema["required"]) if "required" in schema else set(props)
        )
        unknown = required - set(props)
        if unknown:
            raise ValueError(f"required names undeclared properties: {unknown}")
        items = [
            (
                _esc_literal(json.dumps(key))
                + _WS + ":" + _WS
                + schema_to_regex(sub, depth - 1),
                key in required,
            )
            for key, sub in props.items()
        ]
        sep = _WS + "," + _WS
        branches = []
        for i in range(len(items)):
            if any(req for _, req in items[:i]):
                break  # a required item before i cannot be skipped
            body = items[i][0]
            for re_j, req_j in items[i + 1:]:
                seg = sep + re_j
                body += seg if req_j else "(" + seg + ")?"
            branches.append(body)
        inner = "(" + "|".join(branches) + ")"
        if not any(req for _, req in items):
            inner += "?"
        return "\\{" + _WS + inner + _WS + "\\}"
    if t is None:
        return _free_value(depth)
    raise ValueError(f"unsupported schema type {t!r}")


def choice_to_regex(choices: Sequence[str]) -> str:
    if not choices:
        raise ValueError("guided_choice requires at least one option")
    return "(" + "|".join(_esc_literal(str(c)) for c in choices) + ")"


# --------------------------------------------------------------------- #
# token-level FSM
# --------------------------------------------------------------------- #


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[str, _TrieNode] = {}
        self.token_ids: List[int] = []


def _build_trie(vocab: Sequence[str]) -> _TrieNode:
    root = _TrieNode()
    for tid, text in enumerate(vocab):
        if not text:
            continue  # empty decode (special tokens): never admissible
        node = root
        for ch in text:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = node.children[ch] = _TrieNode()
            node = nxt
        node.token_ids.append(tid)
    return root


class TokenFsm:
    """A char DFA lifted to the token vocabulary.

    `allowed(state)` → bool[V] mask of tokens whose FULL string keeps the
    DFA alive from `state` (computed by walking the shared vocab trie —
    tokens sharing prefixes share DFA work — and cached per state).
    EOS ids are admitted exactly in accepting states; if a state admits
    nothing (unsatisfiable pattern), EOS is admitted so generation can
    terminate instead of sampling from an all-masked row.
    """

    def __init__(self, dfa: Dfa, vocab: Sequence[str], eos_ids: Sequence[int]):
        self.dfa = dfa
        self.vocab_size = len(vocab)
        self.eos_ids = [e for e in eos_ids if 0 <= e < len(vocab)]
        self._trie = _build_trie(vocab)
        self._vocab = vocab
        self._masks: Dict[int, np.ndarray] = {}
        self._adv: Dict[Tuple[int, int], int] = {}

    @property
    def start_state(self) -> int:
        return 0

    def allowed(self, state: int) -> np.ndarray:
        cached = self._masks.get(state)
        if cached is not None:
            return cached
        mask = np.zeros((self.vocab_size,), bool)
        if state >= 0:
            stack = [(self._trie, state)]
            while stack:
                node, s = stack.pop()
                for tid in node.token_ids:
                    mask[tid] = True
                for ch, child in node.children.items():
                    ns = self.dfa.step(s, ch)
                    if ns >= 0:
                        stack.append((child, ns))
        if state >= 0 and self.dfa.accept[state]:
            mask[self.eos_ids] = True
        if not mask.any():
            mask[self.eos_ids] = True  # dead end: force termination
        self._masks[state] = mask
        return mask

    def advance(self, state: int, token_id: int) -> int:
        key = (state, token_id)
        cached = self._adv.get(key)
        if cached is not None:
            return cached
        s = self.dfa.walk(state, self._vocab[token_id]) if state >= 0 else -1
        self._adv[key] = s
        return s

    def is_accepting(self, state: int) -> bool:
        return state >= 0 and self.dfa.accept[state]


# --------------------------------------------------------------------- #
# request-surface extraction + compilation
# --------------------------------------------------------------------- #


def extract_guided_spec(response_format, nvext) -> Optional[dict]:
    """Normalize the request's structured-output asks into one guided spec
    dict ({"kind": ..., ...}) or None. Raises ValueError (→ HTTP 400) on
    unsupported or conflicting combinations — silent-accept is worse than
    absent (round-4 verdict weak #7)."""
    specs: List[dict] = []
    if response_format:
        rtype = response_format.get("type")
        if rtype in (None, "text"):
            pass
        elif rtype == "json_object":
            specs.append({"kind": "json_object"})
        elif rtype == "json_schema":
            js = response_format.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            if not isinstance(schema, dict):
                raise ValueError(
                    "response_format.json_schema.schema must be an object"
                )
            specs.append({"kind": "json_schema", "schema": schema})
        else:
            raise ValueError(f"response_format type {rtype!r} not supported")
    if nvext is not None:
        if getattr(nvext, "guided_grammar", None):
            raise ValueError("guided_grammar (EBNF) is not supported")
        if getattr(nvext, "guided_choice", None):
            specs.append({"kind": "choice",
                          "choices": list(nvext.guided_choice)})
        if getattr(nvext, "guided_regex", None):
            specs.append({"kind": "regex", "regex": str(nvext.guided_regex)})
        gj = getattr(nvext, "guided_json", None)
        if gj:
            if isinstance(gj, str):
                try:
                    gj = json.loads(gj)
                except ValueError as e:
                    raise ValueError(f"guided_json is not valid JSON: {e}")
            if not isinstance(gj, dict):
                raise ValueError("guided_json must be a JSON schema object")
            specs.append({"kind": "json_schema", "schema": gj})
    if not specs:
        return None
    if len(specs) > 1:
        raise ValueError(
            "conflicting guided-decoding constraints: specify exactly one of "
            "response_format / guided_choice / guided_regex / guided_json"
        )
    return specs[0]


def spec_to_regex(spec: dict) -> str:
    kind = spec.get("kind")
    try:
        if kind == "regex":
            return spec["regex"]
        if kind == "choice":
            return choice_to_regex(spec["choices"])
        if kind == "json_schema":
            return schema_to_regex(spec["schema"])
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 — malformed client schemas
        # (required: 5, minLength: [2], anyOf: 7, ...) raise TypeError/
        # KeyError deep in the compiler; the serving path maps ONLY
        # ValueError to a 400, so normalize here
        raise ValueError(f"malformed schema: {type(e).__name__}: {e}")
    if kind == "json_object":
        return _free_value(DEFAULT_DEPTH)
    raise ValueError(f"unknown guided kind {kind!r}")


import weakref

# weak-keyed: entries die with their tokenizer (an id()-keyed dict would
# both leak and serve stale vocab after CPython address reuse)
_VOCAB_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def vocab_strings(tokenizer) -> List[str]:
    """id → decoded string for the full vocab, cached per tokenizer
    object. Special tokens decode to "" (inadmissible in the FSM)."""
    try:
        cached = _VOCAB_CACHE.get(tokenizer)
    except TypeError:  # unhashable/non-weakref-able tokenizer: no cache
        cached = None
    if cached is not None:
        return cached
    V = tokenizer.vocab_size
    if callable(V):
        V = V()
    out = [tokenizer.decode([i]) for i in range(V)]
    try:
        _VOCAB_CACHE[tokenizer] = out
    except TypeError:
        pass
    return out


class GuidedCompiler:
    """Spec → TokenFsm with a bounded LRU cache (FSM compiles cost a
    vocab-trie walk; repeated requests with the same schema — the common
    serving pattern — hit the cache, while per-request-unique specs from
    a hostile/buggy client cannot grow it without bound: each TokenFsm
    lazily holds bool[V] masks per visited DFA state)."""

    MAX_ENTRIES = 32

    def __init__(self, tokenizer, max_entries: int = MAX_ENTRIES):
        import threading
        from collections import OrderedDict

        self.tokenizer = tokenizer
        self.max_entries = max_entries
        self._cache: "OrderedDict[str, TokenFsm]" = OrderedDict()
        # compile() runs on asyncio.to_thread workers (engine
        # _compile_guided_async): hit/evict must not race
        self._lock = threading.Lock()

    def compile(self, spec: dict) -> TokenFsm:
        key = json.dumps(spec, sort_keys=True)
        with self._lock:
            fsm = self._cache.get(key)
            if fsm is not None:
                self._cache.move_to_end(key)
                return fsm
        dfa = compile_regex(spec_to_regex(spec))
        eos = self.tokenizer.eos_token_ids
        if callable(eos):
            eos = eos()
        fsm = TokenFsm(dfa, vocab_strings(self.tokenizer), eos)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:  # concurrent miss: first insert wins
                return cached
            self._cache[key] = fsm
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
        return fsm
