"""Execute an UNMODIFIED python-2-era reference script under python 3,
on the port — `paddle_tpu/compat/py2run.py` for PyTorch.

Reference drivers (v1_api_demo/quick_start/api_train.py,
gan/gan_trainer.py, vae/vae_train.py, ...) are python 2: print
statements, xrange, cPickle. The file on disk is never touched — the
source is mechanically converted at load time (lib2to3 fixers) exactly
like the config path injects xrange, then exec'd with
__name__ == '__main__'.

The exec namespace's `__builtins__` are the port's v1 builtins
(`config_parser.v1_builtins`): the script's `from py_paddle import
swig_paddle` resolves to `paddle_tpu_torch/compat/py_paddle` and its
`paddle.trainer.*` imports to the port's v1 namespace, never to the
repo-root shims of the JAX package, and nothing is registered in
`sys.modules` under those names.

`lib2to3` is deprecated but present in Python 3.12 (removed in 3.13);
the conversion uses it as the JAX package does, with the same fixers.
Where it cannot be imported (Python 3.13, or a distribution that ships
it as a separate package: the card's machine has Ubuntu's Python 3.12
without it) `to_py3` falls back to `_to_py3_tokens`, the port's own
token-level conversion of the same fixers' common cases: print
statements (`>>f` and a trailing comma too), `except E, e`, `raise E,
V`, `<>`, long and octal literals, the renamed modules of an import,
`d.has_key(k)`, `it.next()`, `d.iteritems()` and the other `iter*`
methods, `keys()` / `values()` / `items()`, `map` / `filter` / `zip`
as lists, the renamed builtins and function attributes, and
`reduce`. Its text differs from lib2to3's; the tests hold what the
converted code does equal.
"""

from __future__ import annotations

import io
import os
import re
import sys
import tokenize
import warnings

# NOTE: no "xrange" fixer — xrange is injected into the exec globals
# instead (run_py2_script below), so callers can substitute a bounded
# range to keep demo training loops test-sized without editing the file.
_FIXES = [
    "print", "except", "imports", "has_key", "dict", "raise",
    "ne", "numliterals", "funcattrs", "itertools", "itertools_imports",
    "reduce", "basestring", "unicode", "zip", "map", "filter",
    "next",  # generator.next() -> next(generator)
]


def to_py3(src: str, name: str = "<py2 script>", force: bool = False) -> str:
    """Mechanical py2 -> py3 source conversion (no-op if already py3,
    unless `force` — a py2 file can be VALID py3 syntax with different
    semantics, e.g. `len(filter(...))` relying on filter returning a
    list; force runs the fixers regardless). lib2to3 where it imports,
    else `_to_py3_tokens` (module docstring)."""
    if not force:
        try:
            compile(src, name, "exec")
            return src
        except SyntaxError:
            pass
    if not src.endswith("\n"):
        src += "\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # lib2to3 deprecation
        try:
            from lib2to3.refactor import RefactoringTool
        except ImportError:
            return _to_py3_tokens(src)
        rt = RefactoringTool([f"lib2to3.fixes.fix_{f}" for f in _FIXES])
        return str(rt.refactor_string(src, name))


# ---- the conversion without lib2to3 --------------------------------------

_MODULES = {
    "cPickle": "pickle", "cStringIO": "io", "StringIO": "io",
    "Queue": "queue", "ConfigParser": "configparser",
    "urllib2": "urllib.request", "urlparse": "urllib.parse",
    "httplib": "http.client", "HTMLParser": "html.parser",
    "__builtin__": "builtins", "copy_reg": "copyreg",
    "SocketServer": "socketserver", "cookielib": "http.cookiejar",
    "thread": "_thread", "commands": "subprocess", "Tkinter": "tkinter",
}
_BUILTINS = {"unicode": "str", "basestring": "str", "long": "int",
             "raw_input": "input", "unichr": "chr", "intern": "sys.intern",
             "reduce": "__import__('functools').reduce"}
_ATTRS = {"iteritems": "items", "itervalues": "values",
          "iterkeys": "keys", "func_name": "__name__",
          "func_code": "__code__", "func_defaults": "__defaults__",
          "func_globals": "__globals__", "func_doc": "__doc__",
          "func_closure": "__closure__", "im_func": "__func__",
          "im_self": "__self__", "im_class": "__self__.__class__"}
_LISTED = ("map", "filter", "zip")
_VIEWS = ("keys", "values", "items")
_OPEN, _CLOSE = "([{", ")]}"


class _Tokens:
    """The significant tokens of `src` with their text offsets, bracket
    matches and depths."""

    def __init__(self, src: str):
        starts, n = [0], 0
        for line in src.splitlines(keepends=True):
            n += len(line)
            starts.append(n)
        skip = (tokenize.NL, tokenize.COMMENT, tokenize.ENCODING)
        self.src = src
        self.t = [t for t in tokenize.generate_tokens(io.StringIO(
            src).readline) if t.type not in skip]
        self.off = [(starts[t.start[0] - 1] + t.start[1],
                     starts[t.end[0] - 1] + t.end[1]) for t in self.t]
        self.match, self.depth, stack = {}, [], []
        for i, t in enumerate(self.t):
            if t.type == tokenize.OP and t.string in _CLOSE and stack:
                j = stack.pop()
                self.match[i], self.match[j] = j, i
            self.depth.append(len(stack))
            if t.type == tokenize.OP and t.string in _OPEN:
                stack.append(i)

    def s(self, i) -> str:
        return self.t[i].string if 0 <= i < len(self.t) else ""

    def op(self, i, text) -> bool:
        return 0 <= i < len(self.t) and self.t[i].type == tokenize.OP \
            and self.t[i].string == text

    def stmt_start(self, i) -> bool:
        p = self.t[i - 1] if i else None
        return p is None or p.type in (
            tokenize.NEWLINE, tokenize.INDENT, tokenize.DEDENT) or (
            p.type == tokenize.OP and (p.string == ";" or (
                p.string == ":" and self.depth[i - 1] == 0)))

    def stmt_end(self, i) -> int:
        """The index of the NEWLINE / `;` that ends i's statement."""
        d = self.depth[i]
        while not (self.t[i].type in (tokenize.NEWLINE, tokenize.ENDMARKER)
                   or (self.op(i, ";") and self.depth[i] == d)):
            i += 1
        return i

    def listed(self, first, last) -> bool:
        """Whether tokens first..last are already the argument of a
        `list(...)` call (the conversion ran on them)."""
        return self.s(first - 2) == "list" and self.op(first - 1, "(") \
            and self.match.get(first - 1) == last + 1

    def primary(self, dot) -> int:
        """The first token of the primary expression that ends just
        before the `.` at `dot` (a name with attributes, calls and
        subscripts)."""
        j = dot - 1
        while j >= 0:
            t = self.t[j]
            if t.type == tokenize.OP and t.string in _CLOSE and \
                    j in self.match:
                j = self.match[j]
                prev = self.t[j - 1] if j else None
                if prev is not None and (prev.type == tokenize.NAME or (
                        prev.type == tokenize.OP and prev.string in _CLOSE)):
                    j -= 1
                    continue
                return j
            if t.type in (tokenize.NAME, tokenize.NUMBER, tokenize.STRING):
                if self.op(j - 1, "."):
                    j -= 2
                    continue
                return j
            return j + 1
        return 0


def _apply(src: str, edits: list) -> tuple:
    """Apply (start, end, text) edits; an edit overlapping an earlier
    one waits for the next pass."""
    out, pos, done = [], 0, False
    for a, b, text in sorted(edits, key=lambda e: (e[0], -e[1])):
        if a < pos:
            continue
        out += [src[pos:a], text]
        pos, done = b, True
    out.append(src[pos:])
    return "".join(out), done


def _expr_edits(tk: _Tokens) -> list:
    """Every fix but print's, as text edits."""
    edits, t = [], tk.t
    for i, tok in enumerate(t):
        s, a, b = tok.string, tk.off[i][0], tk.off[i][1]
        if tok.type == tokenize.OP and s == "<>":
            edits.append((a, b, "!="))
        elif tok.type == tokenize.NUMBER:
            if re.fullmatch(r"0[0-7]+", s):
                edits.append((a, b, "0o" + s[1:]))
            if tk.s(i + 1) in ("L", "l") and tk.off[i + 1][0] == b:
                edits.append((b, tk.off[i + 1][1], ""))
        elif tok.type != tokenize.NAME:
            continue
        elif tk.op(i - 1, "."):
            if s == "has_key" and tk.op(i + 1, "("):
                p, close = tk.primary(i - 1), tk.match[i + 1]
                arg = tk.src[tk.off[i + 1][1]:tk.off[close][0]]
                edits.append((tk.off[p][0], tk.off[close][1],
                              f"({arg} in {tk.src[tk.off[p][0]:a - 1]})"))
            elif s in ("next",) + _VIEWS and tk.op(i + 1, "(") and \
                    tk.op(i + 2, ")") and not (
                        s in _VIEWS and tk.listed(tk.primary(i - 1), i + 2)):
                p = tk.primary(i - 1)
                obj = tk.src[tk.off[p][0]:tk.off[i - 1][0]]
                new = f"next({obj})" if s == "next" else \
                    f"list({obj}.{s}())"
                edits.append((tk.off[p][0], tk.off[i + 2][1], new))
            elif s in _ATTRS:
                edits.append((a, b, _ATTRS[s]))
        elif s in _BUILTINS and not tk.op(i + 1, "="):
            edits.append((a, b, _BUILTINS[s]))
        elif s in _LISTED and tk.op(i + 1, "(") and not tk.op(i - 1, ".") \
                and not tk.listed(i, tk.match[i + 1]):
            close = tk.match[i + 1]
            edits.append((a, tk.off[close][1],
                          f"list({tk.src[a:tk.off[close][1]]})"))
        elif s == "except":
            j = i + 1
            while not (tk.op(j, ":") and tk.depth[j] == tk.depth[i]):
                if tk.op(j, ",") and tk.depth[j] == tk.depth[i]:
                    edits.append((tk.off[j][0], tk.off[j][1], " as"))
                j += 1
        elif s == "raise" and tk.stmt_start(i):
            end = tk.stmt_end(i)
            commas = [j for j in range(i + 1, end)
                      if tk.op(j, ",") and tk.depth[j] == tk.depth[i]]
            if len(commas) == 1:
                c = commas[0]
                edits.append((tk.off[c][0], tk.off[c][1], "("))
                edits.append((tk.off[end - 1][1], tk.off[end - 1][1], ")"))
        elif s in ("import", "from") and tk.stmt_start(i):
            # each imported module's first name: `import a.b as c, d`,
            # `from a import x`
            end = i + 2 if s == "from" else tk.stmt_end(i)
            firsts = [i + 1] + [j + 1 for j in range(i + 1, end)
                                if tk.op(j, ",")]
            for j in firsts:
                old = tk.s(j)
                if old in _MODULES and not tk.op(j + 1, "."):
                    alias = s == "from" or tk.s(j + 1) == "as"
                    new = _MODULES[old]
                    edits.append((tk.off[j][0], tk.off[j][1],
                                  new if alias else f"{new} as {old}"))
    return edits


def _print_edits(tk: _Tokens) -> list:
    """`print a, b,` / `print >>f, a` / `print` statements as calls."""
    edits = []
    for i, tok in enumerate(tk.t):
        if tok.type != tokenize.NAME or tok.string != "print" or \
                not tk.stmt_start(i):
            continue
        end = tk.stmt_end(i)
        if tk.op(i + 1, "(") and tk.match.get(i + 1) == end - 1:
            continue  # already a call
        args, kw = list(range(i + 1, end)), []
        if args and tk.op(args[0], ">>"):
            comma = next((j for j in args if tk.op(j, ",")
                          and tk.depth[j] == tk.depth[i]), end)
            f = tk.src[tk.off[args[0]][1]:tk.off[comma - 1][1]].strip()
            kw.append(f"file={f}")
            args = list(range(comma + 1, end))
        if args and tk.op(args[-1], ",") and tk.depth[args[-1]] == \
                tk.depth[i]:
            kw.insert(0, 'end=" "')
            args = args[:-1]
        body = tk.src[tk.off[args[0]][0]:tk.off[args[-1]][1]] if args \
            else ""
        call = ", ".join([body] * bool(body) + kw)
        edits.append((tk.off[i][0], tk.off[max(end - 1, i)][1],
                      f"print({call})"))
    return edits


def _to_py3_tokens(src: str) -> str:
    """The fixers' common cases without lib2to3 (module docstring)."""
    for _ in range(4):  # nested fixes land on later passes
        src, done = _apply(src, _expr_edits(_Tokens(src)))
        if not done:
            break
    src, _ = _apply(src, _print_edits(_Tokens(src)))
    return src


def _v1_globals() -> dict:
    from paddle_tpu_torch.compat.config_parser import v1_builtins

    return {"__builtins__": v1_builtins(), "xrange": range}


def load_py2_module(path: str, name: str, extra_globals=None,
                    force: bool = False):
    """Import a python-2-era helper module (e.g. the mnist demo's
    mnist_util.py) with the same mechanical conversion, xrange
    injection and v1 builtins, registering it in sys.modules so the
    driver script's own `import` resolves to it. `force` runs the
    fixers even when the source is syntactically valid py3
    (generator.next() etc.)."""
    import types

    with open(path) as f:
        src = to_py3(f.read(), path, force=force)
    mod = types.ModuleType(name)
    mod.__file__ = os.path.abspath(path)
    mod.__dict__.update(_v1_globals())
    if extra_globals:
        mod.__dict__.update(extra_globals)
    exec(compile(src, path, "exec"), mod.__dict__)
    sys.modules[name] = mod
    return mod


def run_py2_script(path: str, argv=(), extra_globals=None, run_name="__main__"):
    """Exec the script at `path` as __main__ with sys.argv set.

    Returns the script's global namespace (so tests can call into it)."""
    with open(path) as f:
        src = to_py3(f.read(), path)
    code = compile(src, path, "exec")
    g = {
        "__name__": run_name,
        "__file__": os.path.abspath(path),
        **_v1_globals(),
    }
    if extra_globals:
        g.update(extra_globals)
    old_argv = sys.argv
    old_path = list(sys.path)
    sys.argv = [path] + list(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(path)))
    try:
        exec(code, g)
    finally:
        sys.argv = old_argv
        sys.path[:] = old_path
    return g
