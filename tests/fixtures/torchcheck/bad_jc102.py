"""JC102 fixture: lock-order cycles.

`TwoLocks` closes a cycle lexically; `ViaCall` closes one THROUGH the
call graph (the x->y edge exists only because `step` calls `_helper`
with x held). `Suppressed` shows the edge-level pragma: declaring one
nesting safe dissolves the cycle, so the partner site stays quiet too.
"""
import threading


class TwoLocks:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def ab(self):
        with self._la:
            with self._lb:                  # JC102 (a->b edge of cycle)
                pass

    def ba(self):
        with self._lb:
            with self._la:                  # JC102 (b->a closes cycle)
                pass


class ViaCall:
    def __init__(self):
        self._x = threading.Lock()
        self._y = threading.Lock()

    def step(self):
        with self._x:
            self._helper()                  # JC102 (x->y via call graph)

    def _helper(self):
        with self._y:
            pass

    def back(self):
        with self._y:
            with self._x:                   # JC102 (y->x closes cycle)
                pass


class Suppressed:
    def __init__(self):
        self._p = threading.Lock()
        self._q = threading.Lock()

    def pq(self):
        with self._p:
            with self._q:
                pass                        # clean: partner edge waived

    def qp(self):
        # justified: startup-only path, never concurrent with pq()
        with self._q:
            with self._p:   # torchcheck: disable=JC102
                pass
