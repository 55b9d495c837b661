"""BVH builder structure (scene/bvh.py)."""
import numpy as np

from gradientdomain_mitsuba_tpu.scene import bvh as bvh_mod


def test_subtree_ranges_match_leaf_partition():
    """subtree_ranges (vectorized bottom-up) must agree with a direct
    recursive reference on a moderate tree."""
    rs = np.random.RandomState(2)
    T = 20000
    c = rs.uniform(0, 10, (T, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.05, (T, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.05, (T, 3)).astype(np.float32)
    tree = bvh_mod.build_python(c, c + e1, c + e2)
    s, e = bvh_mod.subtree_ranges(tree)

    import sys
    sys.setrecursionlimit(100000)

    def ref(code):
        if code < 0:
            raw = -int(code) - 1
            off = raw >> bvh_mod.LEAF_BITS
            cnt = raw & ((1 << bvh_mod.LEAF_BITS) - 1)
            return (off, off + cnt) if cnt else (1 << 60, 0)
        s0, e0 = ref(tree.child0[code])
        s1, e1_ = ref(tree.child1[code])
        return min(s0, s1), max(e0, e1_)

    for node in rs.choice(tree.num_nodes, size=200, replace=False):
        rs_, re_ = ref(int(node))
        assert (s[node], e[node]) == (rs_, re_), node
    # root covers everything
    assert (s[0], e[0]) == (0, T)
