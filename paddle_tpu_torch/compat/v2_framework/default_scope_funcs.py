"""Thread-local default-scope stack, on the port.

Reference: python/paddle/v2/framework/default_scope_funcs.py — a
thread-local stack of Scopes; new_var/find_var act on the top;
scoped_function runs a callable inside a fresh local scope.
"""

from __future__ import annotations

import threading

from paddle_tpu_torch.compat.v2_framework.core import Scope

__tl_scope__ = threading.local()

__all__ = [
    "get_cur_scope",
    "enter_local_scope",
    "leave_local_scope",
    "new_var",
    "find_var",
    "scoped_function",
]


def get_cur_scope() -> Scope:
    stack = getattr(__tl_scope__, "cur_scope", None)
    if stack is None:
        stack = __tl_scope__.cur_scope = []
    if not stack:
        stack.append(Scope())
    return stack[-1]


def enter_local_scope() -> None:
    cur = get_cur_scope()
    __tl_scope__.cur_scope.append(cur.new_scope())


def leave_local_scope() -> None:
    __tl_scope__.cur_scope.pop()
    get_cur_scope().drop_kids()


def new_var(name: str):
    return get_cur_scope().new_var(name)


def find_var(name: str):
    return get_cur_scope().find_var(name)


def scoped_function(fn) -> None:
    enter_local_scope()
    try:
        fn()
    finally:
        leave_local_scope()
