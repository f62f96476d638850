"""The nestable, thread-local session stack (``repro.runtime.stack``).

Each thread sees an optional stack of explicitly entered sessions
(``repro_torch.session``) and beneath it an *ambient* session, lazily
initialized from the process default, so worker threads start clean and
the deprecated imperative ``set_backend(...)`` can still mutate the
current scope in place.
"""

from __future__ import annotations

import contextlib
import threading

from .session import Session

_DEFAULT = Session()


class _Stack(threading.local):
    def __init__(self):
        self.stack: list[Session] = []
        self.ambient: Session | None = None


_STACK = _Stack()


def default_session() -> Session:
    """The process-wide root session (what a fresh thread sees)."""
    return _DEFAULT


def current_session() -> Session:
    """Innermost active session for this thread (never None)."""
    if _STACK.stack:
        return _STACK.stack[-1]
    if _STACK.ambient is None:
        _STACK.ambient = _DEFAULT
    return _STACK.ambient


def push_session(sess: Session) -> Session:
    """Low-level enter (prefer the ``session`` context manager)."""
    _STACK.stack.append(sess)
    return sess


def pop_session() -> Session:
    """Low-level exit; raises if the stack is empty."""
    return _STACK.stack.pop()


def mutate_current(**overrides) -> Session:
    """Imperatively rewrite the innermost scope (deprecated
    ``set_backend``): inside a ``with session(...)`` block this edits that
    block's session (restored on exit); outside any block it edits the
    thread's ambient session."""
    new = current_session().replace(**overrides)
    if _STACK.stack:
        _STACK.stack[-1] = new
    else:
        _STACK.ambient = new
    return new


@contextlib.contextmanager
def session(base: Session | None = None, **overrides):
    """Enter a session scope: ``with repro_torch.session(backend="hopper"):``

    With no ``base``, overrides derive from the current session, so
    scopes compose.  Passing a ``Session`` as ``base`` enters it verbatim
    (plus any overrides).  The previous state is restored on exit even if
    the body raises.
    """
    if base is None:
        base = current_session()
    elif not isinstance(base, Session):
        raise TypeError(
            f"session() base must be a Session, got {type(base).__name__}")
    new = base.replace(**overrides) if overrides else base
    push_session(new)
    try:
        yield new
    finally:
        pop_session()
