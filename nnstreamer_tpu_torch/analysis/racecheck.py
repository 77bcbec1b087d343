"""nns-san --race: AST concurrency lint over Python source.

The counterpart of ``nnstreamer_tpu/analysis/racecheck.py``, run over the
port's own package by default. The executor is a real concurrent system (per-node service threads,
GIL-atomic ``_Chan`` Dekker pairing, fault gates, batched drain loops, a
stall watchdog) and nothing structural keeps those idioms correct as the
code grows. This pass encodes the repo's concurrency discipline as
checkable rules and reports violations as the same structured
:class:`~nnstreamer_tpu_torch.analysis.diagnostics.Diagnostic` findings nns-lint
uses — ``element`` carries ``file:line`` instead of an element name.

Checks (codes in the shared catalog, ``NNS-R0xx``):

- **NNS-R001 unlocked-shared-write** — in a class that spawns threads, a
  ``self.<attr> += ...`` read-modify-write reached from more than one
  method with at least one site not under a ``with <lock>``. Single-writer
  counters (the FaultStats/BatchStats contract) stay legal because they
  mutate from exactly one method.
- **NNS-R002 blocking-call-under-lock** — ``time.sleep``, ``.join()`` /
  ``.wait()`` without a timeout, ``.recv(`` / ``.accept(`` while a
  ``threading.Lock`` is held (condition variables are exempt: waiting is
  what they are for).
- **NNS-R003 swallowed-interrupt** — bare ``except:`` / ``except
  BaseException:`` that never re-raises (eats KeyboardInterrupt).
- **NNS-R004 silent-except-in-loop** — ``except Exception:`` whose body is
  only ``pass``/``continue`` inside a loop: a service loop that silently
  eats every failure forever.
- **NNS-R005 thread-without-join** — ``threading.Thread(...)`` with
  neither ``daemon=True`` nor a reachable ``.join()``/``.daemon = True``.
- **NNS-R006 dekker-ordering** — a channel-like class (two ``*_waiting``
  flags over a deque) that breaks the documented parking discipline
  (pipeline/executor.py ``_Chan``): the waiter must advertise its flag
  BEFORE re-checking the deque and before parking; the mover must check
  the peer flag AFTER its deque op.

A finding is waived by ``# nns-san: ok`` or any ``# noqa`` on the
offending line — intentional broad catches in this repo already carry
``noqa: BLE001`` annotations with a reason.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from nnstreamer_tpu_torch.analysis.diagnostics import LintReport

_LOCK_NAME = re.compile(r"(lock|mutex)s?$", re.IGNORECASE)
_SYNC_NAME = re.compile(r"(lock|mutex|cv|cond)", re.IGNORECASE)
_WAIVE = re.compile(r"#\s*(nns-san:\s*ok|noqa)")
_GENERATED = ("_pb2.py", "_pb2_grpc.py")


def _dotted(expr: ast.AST) -> Optional[str]:
    """'self._err_lock' for Attribute chains, 'x' for Names, else None."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def _is_lock_ctx(expr: ast.AST, strict: bool) -> bool:
    """True when a `with` context expression names a lock. strict=True
    matches mutexes only (R002: condition waits are idiomatic); False
    also counts condition variables (R001: any synchronized context)."""
    name = _dotted(expr)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return bool((_LOCK_NAME if strict else _SYNC_NAME).search(last))


def _catches(handler: ast.ExceptHandler, names: Tuple[str, ...]) -> bool:
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for x in types:
        if isinstance(x, ast.Name) and x.id in names:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return isinstance(f.value, ast.Name) and f.value.id == "threading"
    return isinstance(f, ast.Name) and f.id == "Thread"


class _FileChecker:
    def __init__(self, path: str, src: str, report: LintReport) -> None:
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.report = report
        self.tree = ast.parse(src, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node

    # -- plumbing ----------------------------------------------------------
    def _where(self, node: ast.AST) -> str:
        return f"{self.path}:{node.lineno}"

    def _waived(self, node: ast.AST) -> bool:
        i = node.lineno - 1
        return 0 <= i < len(self.lines) and bool(_WAIVE.search(self.lines[i]))

    def _add(self, code: str, node: ast.AST, message: str,
             hint: str = "") -> None:
        if not self._waived(node):
            self.report.add(code, self._where(node), message, hint)

    def _ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def run(self) -> None:
        self._check_excepts()
        self._check_locked_blocking()
        self._check_threads()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._check_shared_writes(node)
                self._check_dekker(node)

    # -- R003 / R004 -------------------------------------------------------
    def _check_excepts(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            bare = node.type is None
            if (bare or _catches(node, ("BaseException",))) \
                    and not _reraises(node):
                kind = "bare except" if bare else "except BaseException"
                self._add(
                    "NNS-R003", node,
                    f"{kind} without re-raise swallows KeyboardInterrupt",
                    "catch Exception, or re-raise after cleanup",
                )
                continue  # don't double-report as R004
            if not (bare or _catches(node, ("Exception", "BaseException"))):
                continue
            if not all(isinstance(s, (ast.Pass, ast.Continue))
                       for s in node.body):
                continue
            in_loop = any(
                isinstance(a, (ast.While, ast.For))
                for a in self._ancestors(node)
            )
            if in_loop:
                self._add(
                    "NNS-R004", node,
                    "except Exception with a pass/continue-only body inside "
                    "a loop silently eats every failure",
                    "log the exception, count it, or narrow the except",
                )

    # -- R002 --------------------------------------------------------------
    def _check_locked_blocking(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_is_lock_ctx(i.context_expr, strict=True)
                       for i in node.items):
                continue
            for call in self._calls_under(node.body):
                self._flag_blocking(call)

    def _calls_under(self, body: List[ast.stmt]) -> Iterable[ast.Call]:
        """Calls lexically executed under the with — nested function
        bodies run later, outside the lock, so they don't descend."""
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def _flag_blocking(self, call: ast.Call) -> None:
        f = call.func
        name = _dotted(f) or ""
        kwargs = {k.arg for k in call.keywords}
        if name == "time.sleep":
            self._add("NNS-R002", call,
                      "time.sleep while holding a lock",
                      "sleep outside the critical section")
            return
        if not isinstance(f, ast.Attribute):
            return
        unbounded = not call.args and "timeout" not in kwargs
        if f.attr in ("join", "wait") and unbounded:
            self._add(
                "NNS-R002", call,
                f".{f.attr}() without a timeout while holding a lock",
                "bound the wait or release the lock first",
            )
        elif f.attr in ("recv", "accept"):
            self._add(
                "NNS-R002", call,
                f"blocking socket .{f.attr}() while holding a lock",
                "do network I/O outside the critical section",
            )

    # -- R005 --------------------------------------------------------------
    def _check_threads(self) -> None:
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                continue
            if any(k.arg == "daemon" for k in node.keywords):
                continue  # daemon story declared at the ctor
            target = self._assign_target_of(node)
            if target is not None and self._has_join_story(target):
                continue
            self._add(
                "NNS-R005", node,
                "thread created with neither daemon=True nor a reachable "
                ".join()",
                "pass daemon=True or join it on shutdown",
            )

    def _assign_target_of(self, call: ast.Call) -> Optional[str]:
        parent = self._parents.get(call)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            return _dotted(parent.targets[0])
        if isinstance(parent, ast.AnnAssign):
            return _dotted(parent.target)
        return None

    def _has_join_story(self, target: str) -> bool:
        # textual whole-file search: the join/daemon site usually lives in
        # another method (close/stop), precise scoping buys little here
        pat = rf"(?<![\w.]){re.escape(target)}"
        return bool(
            re.search(rf"{pat}\.join\(", self.src)
            or re.search(rf"{pat}\.daemon\s*=", self.src)
        )

    # -- R001 --------------------------------------------------------------
    def _check_shared_writes(self, cls: ast.ClassDef) -> None:
        if not any(
            isinstance(n, ast.Call) and _is_thread_ctor(n)
            for n in ast.walk(cls)
        ):
            return
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        # chain -> [(method name, AugAssign node, under a sync context)]
        sites: Dict[str, List[Tuple[str, ast.AugAssign, bool]]] = {}
        for m in methods:
            for node in ast.walk(m):
                if not isinstance(node, ast.AugAssign):
                    continue
                chain = _dotted(node.target)
                if chain is None or not chain.startswith("self."):
                    continue
                locked = any(
                    isinstance(a, ast.With)
                    and any(_is_lock_ctx(i.context_expr, strict=False)
                            for i in a.items)
                    for a in self._ancestors(node)
                )
                sites.setdefault(chain, []).append((m.name, node, locked))
        for chain, occ in sites.items():
            if len({m for m, _, _ in occ}) < 2:
                continue  # single-writer method: the documented contract
            for m, node, locked in occ:
                if not locked:
                    self._add(
                        "NNS-R001", node,
                        f"{chain} += from {cls.name}.{m} without the owning "
                        "lock, and other methods also read-modify-write it",
                        "hold the lock at every site, or funnel the "
                        "mutation through one method",
                    )

    # -- R006 --------------------------------------------------------------
    def _check_dekker(self, cls: ast.ClassDef) -> None:
        waiting_attrs: Set[str] = set()
        deque_attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    name = _dotted(t)
                    if name is None or not name.startswith("self."):
                        continue
                    attr = name[5:]
                    if "waiting" in attr:
                        waiting_attrs.add(attr)
                    v = node.value
                    if isinstance(v, ast.Call) and (
                        (isinstance(v.func, ast.Name)
                         and v.func.id == "deque")
                        or (isinstance(v.func, ast.Attribute)
                            and v.func.attr == "deque")
                    ):
                        deque_attrs.add(attr)
        if len(waiting_attrs) < 2 or not deque_attrs:
            return  # not channel-like
        peer_checkers = self._methods_reading(cls, waiting_attrs)
        for m in (n for n in cls.body if isinstance(n, ast.FunctionDef)):
            self._dekker_method(m, waiting_attrs, deque_attrs, peer_checkers)

    def _methods_reading(self, cls: ast.ClassDef, attrs: Set[str]) -> Set[str]:
        out: Set[str] = set()
        for m in (n for n in cls.body if isinstance(n, ast.FunctionDef)):
            for node in ast.walk(m):
                if isinstance(node, ast.Attribute) and node.attr in attrs \
                        and isinstance(node.ctx, ast.Load):
                    out.add(m.name)
                    break
        return out

    def _dekker_method(
        self, m: ast.FunctionDef, waiting: Set[str], deques: Set[str],
        peer_checkers: Set[str],
    ) -> None:
        aliases: Set[str] = set()
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                src = _dotted(node.value)
                if src is not None and src.startswith("self.") \
                        and src[5:] in deques:
                    aliases.add(node.targets[0].id)

        def refs_deque(node: ast.AST) -> bool:
            for n in ast.walk(node):
                if isinstance(n, ast.Name) and n.id in aliases:
                    return True
                if isinstance(n, ast.Attribute) and n.attr in deques:
                    return True
            return False

        flag_sets: List[int] = []      # lineno of self._x_waiting = True
        rechecks: List[int] = []       # lineno of an If test over the deque
        for node in ast.walk(m):
            if isinstance(node, ast.Assign):
                name = _dotted(node.targets[0]) if node.targets else None
                if name and name.startswith("self.") \
                        and name[5:] in waiting \
                        and isinstance(node.value, ast.Constant) \
                        and node.value.value is True:
                    flag_sets.append(node.lineno)
            if isinstance(node, (ast.If, ast.While)) \
                    and refs_deque(node.test):
                rechecks.append(node.lineno)

        for node in ast.walk(m):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            # (a) waiter side: event .wait(...) needs an earlier flag set
            # with a deque recheck in between
            if f.attr == "wait":
                prior = [ln for ln in flag_sets if ln < node.lineno]
                if not prior:
                    self._add(
                        "NNS-R006", node,
                        "event wait without advertising a *_waiting flag "
                        "first — the peer cannot see the parked waiter",
                        "set the waiting flag, re-check the deque, then "
                        "wait (executor._Chan discipline)",
                    )
                    continue
                last_set = max(prior)
                if not any(last_set < ln <= node.lineno for ln in rechecks):
                    self._add(
                        "NNS-R006", node,
                        "no deque re-check between setting the waiting "
                        "flag and parking — a push between the first "
                        "check and the flag set is missed",
                        "re-check the deque after advertising the flag",
                    )
            # (b) mover side: append/popleft must be followed by a peer
            # flag check (directly or via a sibling helper)
            if f.attr in ("append", "popleft"):
                tgt = _dotted(f.value) or ""
                is_chan_deque = tgt in aliases or (
                    tgt.startswith("self.") and tgt[5:] in deques
                )
                if not is_chan_deque:
                    continue
                if not self._flag_check_after(m, node, waiting,
                                              peer_checkers):
                    self._add(
                        "NNS-R006", node,
                        f"deque .{f.attr}() with no peer waiting-flag "
                        "check afterwards — a parked peer sleeps out its "
                        "full timeout beat",
                        "check the *_waiting flag (or call the wake "
                        "helper) after the deque op",
                    )

    def _flag_check_after(
        self, m: ast.FunctionDef, op: ast.Call, waiting: Set[str],
        peer_checkers: Set[str],
    ) -> bool:
        for node in ast.walk(m):
            ln = getattr(node, "lineno", None)
            if ln is None or ln < op.lineno:
                continue
            if isinstance(node, ast.Attribute) and node.attr in waiting \
                    and isinstance(node.ctx, ast.Load):
                return True
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in peer_checkers:
                return True
        return False


# -- entry points ------------------------------------------------------------

def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for root in paths:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if fn.endswith(".py") and not fn.endswith(_GENERATED):
                    out.append(os.path.join(dirpath, fn))
    return out


def check_source(src: str, path: str, report: LintReport) -> None:
    try:
        _FileChecker(path, src, report).run()
    except SyntaxError as exc:
        report.add("NNS-E009", path, f"not parseable as Python: {exc}")


def run_race_lint(paths: Iterable[str],
                  report: Optional[LintReport] = None) -> LintReport:
    """Race-lint every .py under `paths`; returns the shared LintReport."""
    report = report if report is not None else LintReport()
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except OSError as exc:
            report.add("NNS-E009", path, f"unreadable: {exc}")
            continue
        check_source(src, os.path.relpath(path), report)
    return report
