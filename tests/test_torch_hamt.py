"""The reference's HAMT tests (tests/test_hamt.py) against the port's copy
of utils/hamt.py, their assertions unchanged.
"""

import random

from nomad_tpu_torch.utils.hamt import Hamt


def test_basic_set_get():
    m = Hamt()
    m2 = m.set("a", 1).set("b", 2)
    assert len(m) == 0          # persistence: original untouched
    assert len(m2) == 2
    assert m2["a"] == 1 and m2["b"] == 2
    assert m.get("a") is None


def test_overwrite():
    m = Hamt().set("k", 1)
    m2 = m.set("k", 2)
    assert m["k"] == 1
    assert m2["k"] == 2
    assert len(m2) == 1


def test_delete():
    m = Hamt().set("a", 1).set("b", 2).set("c", 3)
    m2 = m.delete("b")
    assert len(m2) == 2
    assert "b" not in m2
    assert m["b"] == 2
    assert m.delete("zzz") is m


def test_random_fuzz_against_dict():
    rng = random.Random(42)
    m = Hamt()
    ref = {}
    snapshots = []
    for i in range(5000):
        op = rng.random()
        key = f"key-{rng.randint(0, 800)}"
        if op < 0.6:
            v = rng.randint(0, 10**9)
            m = m.set(key, v)
            ref[key] = v
        elif op < 0.9:
            m = m.delete(key)
            ref.pop(key, None)
        else:
            snapshots.append((m, dict(ref)))
    assert len(m) == len(ref)
    assert dict(m.items()) == ref
    # every snapshot must still read its own frozen state
    for snap, snap_ref in snapshots:
        assert len(snap) == len(snap_ref)
        assert dict(snap.items()) == snap_ref


class _BadHash:
    """Forces hash collisions to exercise _Collision nodes."""
    def __init__(self, v):
        self.v = v

    def __hash__(self):
        return 7

    def __eq__(self, other):
        return isinstance(other, _BadHash) and self.v == other.v


def test_hash_collisions():
    a, b, c = _BadHash(1), _BadHash(2), _BadHash(3)
    m = Hamt().set(a, "a").set(b, "b").set(c, "c")
    assert m[a] == "a" and m[b] == "b" and m[c] == "c"
    assert len(m) == 3
    m2 = m.delete(b)
    assert len(m2) == 2
    assert m2.get(b) is None and m2[a] == "a" and m2[c] == "c"
    m3 = m2.delete(a).delete(c)
    assert len(m3) == 0
    # overwrite inside collision node
    m4 = m.set(b, "B")
    assert m4[b] == "B" and len(m4) == 3
