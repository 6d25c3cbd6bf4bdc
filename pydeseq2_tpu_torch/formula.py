"""Host-side Wilkinson-formula design matrices and contrast vectors.

A copy of ``pydeseq2_tpu/formula.py`` (numpy and pandas only), kept
here so the port does not import the JAX package.

Replaces the reference's ``formulaic`` + ``formulaic-contrasts`` dependency
(reference pydeseq2/dds.py:10,296-302 and pydeseq2/ds.py:590-601) with a
self-contained materializer implementing the Wilkinson grammar surface the
DESeq2 workflow uses:

    ~ a + b + a:b        explicit interactions
    ~ a * b * c          crossing: ALL main effects + pairwise + higher
                         interactions (a+b+c+a:b+a:c+b:c+a:b:c)
    ~ (a + b) * c        parenthesised grouping
    ~ a / b              nesting (a + a:b)
    ~ (a + b + c) ** 2   interactions up to a given order
    ~ a * b - a:b        term removal
    ~ 0 + a   /  ~ a - 1 intercept removal (with full dummy coding of the
                         first categorical, as formulaic/patsy produce)
    ~ C(x)               force categorical coding
    ~ C(x, ref="B")      treatment coding against an explicit reference level
      (also accepted: ``C(x, Treatment("B"))``, ``C(x, Treatment(reference=
      "B"))``, ``C(x, contr.treatment("B"))``, ``C(x, contr.treatment(base=
      "B"))``, ``C(x, levels=["B", "A"])`` — first listed level = reference)

Semantics follow formulaic's defaults:

- terms are ordered by interaction degree (main effects first, then pairwise,
  then triple, ...), keeping the order of appearance within a degree;
- categorical variables (object/category/bool dtype, or wrapped in ``C()``)
  are treatment-coded against the first level (sorted, pandas categorical
  order, or the ``C()`` override), producing columns named ``var[T.level]``;
- structural redundancy is resolved the way patsy/formulaic do: a
  categorical factor is coded FULL rank (columns ``var[level]`` for every
  level) exactly when the lower-order subspace it would otherwise alias is
  not already spanned by earlier terms — e.g. ``~ 0 + condition`` yields one
  column per level, and ``~ group + group:condition`` codes ``group`` full
  inside the interaction;
- numeric variables pass through as a single column named after the variable;
- anything outside this grammar (function calls other than ``C``, arithmetic
  on variables, unknown operators) raises ``ValueError`` instead of silently
  misparsing.

Everything here is host/NumPy code - design matrices are tiny (N x P with
P <= ~10) and are replicated across the device mesh.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import pandas as pd

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_OPS = ("**", "+", "-", "*", ":", "/", "(", ")")


def _is_ident_start(ch: str) -> bool:
    return ch.isalpha() or ch == "_"


def _is_ident_char(ch: str) -> bool:
    return ch.isalnum() or ch in "._"


def _tokenize(src: str) -> list[tuple[str, str]]:
    """Split a formula RHS into (kind, text) tokens.

    Kinds: OP, NUM, NAME, CFUNC (a full ``C(...)`` call, balanced parens).
    """
    tokens: list[tuple[str, str]] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch.isspace():
            i += 1
            continue
        if src.startswith("**", i):
            tokens.append(("OP", "**"))
            i += 2
            continue
        if ch in "+-*:/()":
            tokens.append(("OP", ch))
            i += 1
            continue
        if ch.isdigit():
            j = i + 1
            while j < n and (src[j].isdigit() or src[j] == "."):
                j += 1
            tokens.append(("NUM", src[i:j]))
            i = j
            continue
        if ch == "`":  # backtick-quoted column name (formulaic-compatible)
            j = src.find("`", i + 1)
            if j < 0:
                raise ValueError(f"Unterminated backtick in formula: {src!r}")
            tokens.append(("NAME", src[i + 1 : j]))
            i = j + 1
            continue
        if _is_ident_start(ch):
            j = i + 1
            while j < n and _is_ident_char(src[j]):
                j += 1
            name = src[i:j]
            # function call?
            k = j
            while k < n and src[k].isspace():
                k += 1
            if k < n and src[k] == "(":
                if name != "C":
                    raise ValueError(
                        f"Unsupported function '{name}(...)' in design formula "
                        f"{src!r}: only the categorical operator C(...) is "
                        "supported. Apply transforms to the metadata column "
                        "before constructing the dataset."
                    )
                # consume balanced parens, respecting quotes
                depth, m = 0, k
                while m < n:
                    c = src[m]
                    if c in "\"'":
                        q = src.find(c, m + 1)
                        if q < 0:
                            raise ValueError(
                                f"Unterminated string in formula: {src!r}"
                            )
                        m = q + 1
                        continue
                    if c == "(":
                        depth += 1
                    elif c == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    m += 1
                if depth != 0:
                    raise ValueError(f"Unbalanced parentheses in formula: {src!r}")
                tokens.append(("CFUNC", src[i : m + 1]))
                i = m + 1
                continue
            tokens.append(("NAME", name))
            i = j
            continue
        raise ValueError(
            f"Unsupported character {ch!r} in design formula {src!r}. "
            "Supported syntax: variables, C(...), and the operators "
            "+ - * : / ** ( )."
        )
    return tokens


# ---------------------------------------------------------------------------
# C(...) argument parsing
# ---------------------------------------------------------------------------


def _split_call_args(argstr: str) -> list[str]:
    """Split the inside of ``C(...)`` on top-level commas."""
    parts, depth, start = [], 0, 0
    i = 0
    while i < len(argstr):
        c = argstr[i]
        if c in "\"'":
            q = argstr.find(c, i + 1)
            if q < 0:
                raise ValueError(f"Unterminated string in C(...): {argstr!r}")
            i = q + 1
            continue
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(argstr[start:i].strip())
            start = i + 1
        i += 1
    tail = argstr[start:].strip()
    if tail:
        parts.append(tail)
    return parts


def _parse_literal(text: str):
    """Parse a quoted string or a number literal inside C(...)."""
    text = text.strip()
    if len(text) >= 2 and text[0] in "\"'" and text[-1] == text[0]:
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        raise ValueError(
            f"Cannot parse literal {text!r} inside C(...): expected a quoted "
            "string or a number."
        ) from None


def _parse_c_call(text: str) -> tuple[str, object | None, list | None]:
    """Parse ``C(var, ...)`` -> (variable, reference-level, explicit levels).

    Accepts the reference-level spellings formulaic/patsy users write
    (reference pydeseq2 passes formulas verbatim to formulaic at
    dds.py:296-302): ``ref=``, ``Treatment(...)``, ``contr.treatment(...)``,
    and ``levels=[...]``.
    """
    inner = text[text.index("(") + 1 : text.rindex(")")]
    args = _split_call_args(inner)
    if not args:
        raise ValueError(f"C(...) needs a variable name: {text!r}")
    var = args[0].strip().strip("`")
    if not var or not _is_ident_start(var[0]) or not all(
        _is_ident_char(c) for c in var
    ):
        raise ValueError(
            f"C(...) must wrap a plain metadata column name, got {args[0]!r} "
            f"in {text!r}. Transforms inside C(...) are not supported."
        )
    ref: object | None = None
    levels: list | None = None
    for arg in args[1:]:
        key, _, val = arg.partition("=")
        key, val = key.strip(), val.strip()
        if "=" in arg and key in ("ref", "reference", "base") and "(" not in key:
            ref = _parse_literal(val)
        elif "=" in arg and key == "levels":
            if not (val.startswith("[") or val.startswith("(")):
                raise ValueError(f"levels= expects a list in {text!r}")
            items = _split_call_args(val[1:-1])
            levels = [_parse_literal(v) for v in items]
        elif arg.startswith(("Treatment", "contr.treatment")):
            cinner = arg[arg.index("(") + 1 : arg.rindex(")")].strip()
            if cinner:
                ckey, _, cval = cinner.partition("=")
                if cval:
                    if ckey.strip() not in ("reference", "base", "ref"):
                        raise ValueError(
                            f"Unsupported treatment-coding argument {cinner!r} "
                            f"in {text!r}."
                        )
                    ref = _parse_literal(cval)
                else:
                    ref = _parse_literal(cinner)
        else:
            raise ValueError(
                f"Unsupported C(...) argument {arg!r} in {text!r}. Supported: "
                "ref=<level>, levels=[...], Treatment(<level>), "
                "contr.treatment(<level>). Other contrast codings "
                "(sum/poly/helmert) are not implemented."
            )
    return var, ref, levels


# ---------------------------------------------------------------------------
# Factors, terms and the formula algebra
# ---------------------------------------------------------------------------


class Factor:
    """One variable appearing in a term (identity = its literal spelling)."""

    def __init__(
        self,
        name: str,
        categorical: bool | None,
        display: str,
        ref: object | None = None,
        levels_override: list | None = None,
    ):
        self.name = name  # metadata column name
        self.categorical = categorical  # None = decide from dtype
        self.display = display  # literal spelling, e.g. C(x, ref='B')
        self.ref = ref
        self.levels_override = levels_override
        self.levels: list | None = None  # resolved at fit time

    def __repr__(self):  # pragma: no cover
        return f"Factor({self.display}, cat={self.categorical})"


# A term is a tuple of Factor objects; the intercept is the empty tuple.
Term = tuple


class _TermSet:
    """Ordered, deduplicated set of terms with the Wilkinson algebra."""

    def __init__(self, terms: list[Term], intercept_removed: bool = False):
        self.terms = list(dict.fromkeys(terms))
        self.intercept_removed = intercept_removed

    @staticmethod
    def _interact(a: Term, b: Term) -> Term:
        seen: dict[str, Factor] = {}
        for f in a + b:
            seen.setdefault(f.display, f)
        return tuple(seen.values())

    def union(self, other: "_TermSet") -> "_TermSet":
        ts = _TermSet(
            self.terms + other.terms,
            self.intercept_removed or other.intercept_removed,
        )
        if other.intercept_removed:
            ts.terms = [t for t in ts.terms if t != ()]
        return ts

    def difference(self, other: "_TermSet") -> "_TermSet":
        keys = {tuple(f.display for f in t) for t in other.terms}
        removed_intercept = () in other.terms
        return _TermSet(
            [t for t in self.terms if tuple(f.display for f in t) not in keys],
            self.intercept_removed or removed_intercept,
        )

    def cross(self, other: "_TermSet") -> "_TermSet":
        return _TermSet(
            [self._interact(a, b) for a in self.terms for b in other.terms],
            self.intercept_removed or other.intercept_removed,
        )

    def star(self, other: "_TermSet") -> "_TermSet":
        return self.union(other).union(self.cross(other))

    def nest(self, other: "_TermSet") -> "_TermSet":
        # a / b  ==  a + (full interaction of a's factors):b
        full: Term = ()
        for t in self.terms:
            full = self._interact(full, t)
        return self.union(_TermSet([full]).cross(other))

    def power(self, k: int) -> "_TermSet":
        out, cur = self, self
        for _ in range(k - 1):
            cur = cur.cross(self)
            out = out.union(cur)
        return out


class _Parser:
    """Recursive-descent parser for the formula RHS.

    Precedence (loosest to tightest), as in patsy/formulaic:
    ``+ -``  <  ``* /``  <  ``:``  <  ``**``.
    """

    def __init__(self, tokens: list[tuple[str, str]], src: str):
        self.tokens = tokens
        self.pos = 0
        self.src = src

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise ValueError(f"Unexpected end of design formula: {self.src!r}")
        self.pos += 1
        return tok

    def parse(self) -> _TermSet:
        ts = self.parse_sum()
        if self.peek() is not None:
            raise ValueError(
                f"Unexpected {self.peek()[1]!r} in design formula {self.src!r}"
            )
        return ts

    def parse_sum(self) -> _TermSet:
        acc = self.parse_prod()
        while self.peek() in (("OP", "+"), ("OP", "-")):
            op = self.next()[1]
            rhs = self.parse_prod()
            acc = acc.union(rhs) if op == "+" else acc.difference(rhs)
        return acc

    def parse_prod(self) -> _TermSet:
        acc = self.parse_colon()
        while self.peek() in (("OP", "*"), ("OP", "/")):
            op = self.next()[1]
            rhs = self.parse_colon()
            acc = acc.star(rhs) if op == "*" else acc.nest(rhs)
        return acc

    def parse_colon(self) -> _TermSet:
        acc = self.parse_power()
        while self.peek() == ("OP", ":"):
            self.next()
            acc = acc.cross(self.parse_power())
        return acc

    def parse_power(self) -> _TermSet:
        acc = self.parse_atom()
        while self.peek() == ("OP", "**"):
            self.next()
            kind, text = self.next()
            if kind != "NUM" or not text.isdigit() or int(text) < 1:
                raise ValueError(
                    f"The ** operator needs a positive integer exponent, got "
                    f"{text!r} in {self.src!r}"
                )
            acc = acc.power(int(text))
        return acc

    def parse_atom(self) -> _TermSet:
        kind, text = self.next()
        if kind == "OP" and text == "(":
            inner = self.parse_sum()
            close = self.next()
            if close != ("OP", ")"):
                raise ValueError(f"Unbalanced parentheses in {self.src!r}")
            return inner
        if kind == "NUM":
            if text == "1":
                return _TermSet([()])
            if text == "0":
                return _TermSet([], intercept_removed=True)
            raise ValueError(
                f"Numeric literal {text!r} is not a valid formula term in "
                f"{self.src!r} (only 0 and 1 are meaningful)."
            )
        if kind == "NAME":
            return _TermSet([(Factor(text, None, text),)])
        if kind == "CFUNC":
            var, ref, levels = _parse_c_call(text)
            return _TermSet(
                [(Factor(var, True, text, ref=ref, levels_override=levels),)]
            )
        raise ValueError(f"Unexpected {text!r} in design formula {self.src!r}")


def _parse_formula(formula: str) -> tuple[list[Term], bool]:
    """Parse a formula into (degree-ordered terms, intercept flag)."""
    rhs = formula.split("~", 1)[1] if "~" in formula else formula
    rhs = rhs.strip()
    if not rhs:
        raise ValueError(f"Empty design formula: {formula!r}")
    ts = _Parser(_tokenize(rhs), formula).parse()
    # implicit intercept unless removed by 0 / -1
    intercept = not ts.intercept_removed
    terms = [t for t in ts.terms if t != ()]
    # formulaic's default ordering: by interaction degree, stable within one
    terms = sorted(terms, key=len)
    return terms, intercept


# ---------------------------------------------------------------------------
# Design matrix with patsy/formulaic-style redundancy-aware coding
# ---------------------------------------------------------------------------


class DesignMatrix:
    """A fitted design: formula -> (N, P) matrix + state for contrasts.

    Attributes
    ----------
    matrix : pandas.DataFrame
        The materialized design matrix (samples x columns).
    levels : dict
        Categorical variable -> ordered list of levels (first = reference).
    variables : list of str
        Variable names appearing in the formula.
    """

    def __init__(self, metadata: pd.DataFrame, formula: str):
        self.formula = formula
        self.terms, self.intercept = _parse_formula(formula)
        self.levels: dict[str, list] = {}

        for term in self.terms:
            for f in term:
                if f.name not in metadata.columns:
                    raise KeyError(
                        f"Variable '{f.name}' of the design formula is not a "
                        "column of the metadata."
                    )
                if f.categorical is None:
                    dtype = metadata[f.name].dtype
                    f.categorical = isinstance(
                        dtype, pd.CategoricalDtype
                    ) or not pd.api.types.is_numeric_dtype(dtype)
                if f.categorical:
                    f.levels = self._resolve_levels(f, metadata[f.name])
                    # per-variable view (first C() / bare spelling wins)
                    self.levels.setdefault(f.name, f.levels)

        self.variables = list(
            dict.fromkeys(f.name for term in self.terms for f in term)
        )
        self._encoding = self._encode_terms()
        self.matrix = self._materialize(metadata)

    @staticmethod
    def _resolve_levels(f: Factor, col: pd.Series) -> list:
        if f.levels_override is not None:
            levels = list(f.levels_override)
            observed = set(pd.unique(col.dropna()).tolist())
            missing = observed - set(levels)
            if missing:
                raise ValueError(
                    f"levels= of {f.display!r} does not cover observed "
                    f"values {sorted(missing, key=str)} of '{f.name}'."
                )
        else:
            if isinstance(col.dtype, pd.CategoricalDtype):
                levels = list(col.cat.categories)
            else:
                levels = sorted(pd.unique(col.dropna()).tolist(), key=str)
            if f.ref is not None:
                if f.ref not in levels:
                    raise ValueError(
                        f"Reference level {f.ref!r} of {f.display!r} is not a "
                        f"level of '{f.name}'. Levels: {levels}."
                    )
                levels = [f.ref] + [lv for lv in levels if lv != f.ref]
        if len(levels) == 1:
            warnings.warn(
                f"Factor '{f.name}' has only one level; the design "
                "matrix column it generates is constant.",
                UserWarning,
                stacklevel=4,
            )
        return levels

    # -- redundancy-aware encoding (patsy's algorithm) ---------------------
    def _encode_terms(self):
        """Decide full vs reduced coding per categorical factor per term.

        Implements the structural-redundancy rule formulaic/patsy apply: each
        term spans 2^k subspaces (one per subset of its categorical factors);
        subspaces already contributed by earlier terms (or the intercept) are
        dropped, and the remainder is greedily merged into product blocks.
        A factor coded "full" contributes every level; "reduced" drops the
        reference level.

        Returns a list (one entry per term) of blocks; each block maps
        factor display -> "num" | "full" | "reduced".
        """
        used: set[tuple[frozenset, frozenset]] = set()
        if self.intercept:
            used.add((frozenset(), frozenset()))
        encoding = []
        for term in self.terms:
            num = frozenset(f.display for f in term if not f.categorical)
            cats = [f.display for f in term if f.categorical]
            pieces = []
            for r in range(len(cats) + 1):
                for sub in itertools.combinations(cats, r):
                    key = (num, frozenset(sub))
                    if key not in used:
                        pieces.append(frozenset(sub))
                        used.add(key)
            # greedy merge: blocks are (reduced-set, full-set); a block covers
            # {reduced ∪ T : T ⊆ full}; merge sibling blocks differing by one
            blocks = {(s, frozenset()) for s in pieces}
            merged = True
            while merged:
                merged = False
                for s1, f1 in list(blocks):
                    for c in cats:
                        if c in s1:
                            continue
                        sib = (s1 | {c}, f1)
                        if sib in blocks:
                            blocks.discard((s1, f1))
                            blocks.discard(sib)
                            blocks.add((s1, f1 | {c}))
                            merged = True
                            break
                    if merged:
                        break
            term_blocks = []
            for s, fl in sorted(
                blocks, key=lambda b: (len(b[0]) + len(b[1]), sorted(b[0]))
            ):
                spec = {}
                for f in term:
                    if not f.categorical:
                        spec[f.display] = "num"
                    elif f.display in fl:
                        spec[f.display] = "full"
                    elif f.display in s:
                        spec[f.display] = "reduced"
                    # factors in neither coded at intercept: omitted
                term_blocks.append(spec)
            encoding.append(term_blocks)
        return encoding

    # -- materialization ---------------------------------------------------
    def _factor_columns(self, f: Factor, kind: str, data: pd.DataFrame):
        col = data[f.name]
        if kind == "num":
            if not pd.api.types.is_numeric_dtype(col):
                raise ValueError(
                    f"Variable '{f.name}' is non-numeric but is used as a "
                    "numeric factor."
                )
            return [(f.display, col.to_numpy().astype(float))]
        levels = f.levels if f.levels is not None else self.levels[f.name]
        if kind == "full":
            return [
                (f"{f.display}[{lvl}]", (col == lvl).to_numpy().astype(float))
                for lvl in levels
            ]
        return [
            (f"{f.display}[T.{lvl}]", (col == lvl).to_numpy().astype(float))
            for lvl in levels[1:]
        ]

    def _materialize(self, data: pd.DataFrame) -> pd.DataFrame:
        cols: dict[str, np.ndarray] = {}
        if self.intercept:
            cols["Intercept"] = np.ones(len(data))
        for term, term_blocks in zip(self.terms, self._encoding):
            for spec in term_blocks:
                per_factor = [
                    self._factor_columns(f, spec[f.display], data)
                    for f in term
                    if f.display in spec
                ]
                if not per_factor:
                    continue
                for combo in itertools.product(*per_factor):
                    name = ":".join(c[0] for c in combo)
                    vals = np.prod(
                        np.stack([c[1] for c in combo], axis=0), axis=0
                    )
                    cols[name] = vals
        return pd.DataFrame(cols, index=data.index)

    # -- contrasts ---------------------------------------------------------
    def _factor_levels(self, var: str) -> list:
        return self.levels[var]

    def cond(self, **kwargs) -> np.ndarray:
        """Model-matrix row for a condition; unspecified categorical variables
        sit at their reference level, unspecified numeric variables at 0.

        Parity: formulaic_contrasts.FormulaicContrasts.cond as used at
        reference pydeseq2/dds.py:564-578.
        """
        unknown = set(kwargs) - set(self.variables)
        if unknown:
            raise ValueError(
                f"Variables {sorted(unknown)} are not part of the design."
            )
        row: dict = {}
        for var in self.variables:
            if var in self.levels:
                val = kwargs.get(var, self.levels[var][0])
                if val not in self.levels[var]:
                    raise ValueError(
                        f"Value '{val}' is not a level of variable '{var}'. "
                        f"Available levels: {self.levels[var]}."
                    )
                row[var] = val
            else:
                row[var] = kwargs.get(var, 0.0)
        mat = self._materialize(pd.DataFrame([row]))
        vec = np.zeros(self.matrix.shape[1])
        for i, name in enumerate(self.matrix.columns):
            if name in mat.columns:
                vec[i] = mat[name].iloc[0]
        return vec

    def contrast(self, column: str, baseline, group_to_compare) -> np.ndarray:
        """Contrast vector for ``column``: ``group_to_compare`` vs ``baseline``.

        Parity: formulaic_contrasts.FormulaicContrasts.contrast as used at
        reference pydeseq2/dds.py:580-582, pydeseq2/ds.py:590-601.
        """
        return self.cond(**{column: group_to_compare}) - self.cond(
            **{column: baseline}
        )


def build_design_matrix(metadata: pd.DataFrame, formula: str) -> DesignMatrix:
    """Materialize a design matrix from a formula (convenience wrapper)."""
    return DesignMatrix(metadata, formula)
