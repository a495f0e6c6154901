"""Limb-exact model of K2's field arithmetic (keyhuntm1cpu_tpu_torch/csrc/
fe_walk.cuh): the same PTX carry chains, word by word, on Python ints.

Every chain keeps the carry flag as the PTX does (``.cc`` sets it, ``c``
reads it). Where the kernel relies on a bound instead of a carry word, the
model asserts it at that step:
- a chain that ends without ``.cc`` cannot carry out of its last word;
- a row chain without a carry word ends on a word not written yet (0), and
  one with a carry word sets a word not written yet;
- the reduction's top word pair is < 2^33 and, where its high word is 1,
  its low word < 2^11 (so r8 + 977 r9 fits a word); it wraps 2^256 at most
  once, and the wrapped rest plus 2^32 + 977 stays in three words;
- a subtraction's second borrow chain never borrows out.
So the model fails on an input where the kernel's arithmetic would drop a
carry, not only on a wrong result.
"""

P = 2**256 - 2**32 - 977
M32 = 0xFFFFFFFF


def to_words(v, n=8):
    return [(v >> (32 * i)) & M32 for i in range(n)]


def from_words(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


class CC:
    """The carry flag of one PTX carry chain."""

    def __init__(self):
        self.c = 0

    def add(self, x, y, cin, cout):
        """x + y (+ the flag if cin), the flag set from the carry if cout;
        without cout the carry must be 0 (the kernel drops it)."""
        s = x + y + (self.c if cin else 0)
        if cout:
            self.c = s >> 32
        else:
            assert s >> 32 == 0, "a chain without .cc carried out"
        return s & M32

    def sub(self, x, y, bin_, bout):
        s = x - y - (self.c if bin_ else 0)
        if bout:
            self.c = 1 if s < 0 else 0
        else:
            assert s >= 0, "a chain without .cc borrowed out"
        return s & M32


def lo(a, b):
    return (a * b) & M32


def hi(a, b):
    return (a * b) >> 32


def mul_row(r, off, a, b):
    """fw_mul4 / fw_mul3: r[off + 2k], r[off + 2k + 1] = a_k b (set)."""
    for k, x in enumerate(a):
        r[off + 2 * k], r[off + 2 * k + 1] = lo(x, b), hi(x, b)


def mad_row(r, off, a, b, carry):
    """fw_mad<K, CARRY>: r[off .. off + 2K) += a b as lo/hi pairs."""
    n = 2 * len(a)
    if carry:
        assert r[off + n] == 0, "a carry word written before its chain"
    else:
        assert r[off + n - 1] == 0, "a chain without a carry word ends on a written word"
    cc = CC()
    for k, x in enumerate(a):
        last = k == len(a) - 1
        r[off + 2 * k] = cc.add(lo(x, b), r[off + 2 * k], k > 0, True)
        r[off + 2 * k + 1] = cc.add(hi(x, b), r[off + 2 * k + 1], True, carry or not last)
    if carry:
        r[off + n] = cc.add(0, 0, True, False)


def merge(e, o):
    """fw_merge: e[1..16) += o[0..15), one chain (the flag carried between
    the kernel's two asm statements through a word)."""
    cc = CC()
    for k in range(1, 9):
        e[k] = cc.add(e[k], o[k - 1], k > 1, True)
    c = cc.add(0, 0, True, False)
    cc = CC()
    cc.add(c, M32, False, True)
    for k in range(9, 16):
        e[k] = cc.add(e[k], o[k - 1], True, k < 15)


def reduce(t):
    """fw_reduce: t (16 words, < 2^512) mod p into 8 words < 2^256."""
    assert len(t) == 16 and all(0 <= x <= M32 for x in t)
    h = t[8:]
    r = [0] * 10
    cc = CC()
    for k in range(4):  # lo + the even limbs of hi times 977
        r[2 * k] = cc.add(lo(h[2 * k], 977), t[2 * k], k > 0, True)
        r[2 * k + 1] = cc.add(hi(h[2 * k], 977), t[2 * k + 1], True, True)
    r[8] = cc.add(0, 0, True, False)
    cc = CC()
    for k in range(4):  # the odd limbs, one word up
        r[2 * k + 1] = cc.add(lo(h[2 * k + 1], 977), r[2 * k + 1], k > 0, True)
        r[2 * k + 2] = cc.add(hi(h[2 * k + 1], 977), r[2 * k + 2], True, k < 3)
    cc = CC()
    for k in range(8):  # hi * 2^32
        r[k + 1] = cc.add(r[k + 1], h[k], k > 0, True)
    r[9] = cc.add(0, 0, True, False)
    r8, r9 = r[8], r[9]
    assert r9 <= 1 and (r9 == 0 or r8 < 1 << 11), "the top word pair out of its bound"
    s1 = r8 + 977 * r9
    assert s1 <= M32
    cc = CC()
    r[1] = cc.add(r[1], s1, False, True)
    r[2] = cc.add(r[2], r9, True, True)
    for k in range(3, 8):
        r[k] = cc.add(r[k], 0, True, True)
    w = cc.add(0, 0, True, False)
    cc = CC()
    r[0] = cc.add(lo(r8, 977), r[0], False, True)
    r[1] = cc.add(hi(r8, 977), r[1], True, True)
    for k in range(2, 8):
        r[k] = cc.add(r[k], 0, True, True)
    w = cc.add(w, 0, True, False)
    assert w <= 1
    if w:
        assert from_words(r[:8]) < 1 << 66, "wrapped to more than 2^66"
    cc = CC()
    r[0] = cc.add(lo(w, 977), r[0], False, True)
    r[1] = cc.add(r[1], w, True, True)
    r[2] = cc.add(r[2], 0, True, False)
    return r[:8]


def mul(a, b):
    """fw_mul on 8-word lists (each < 2^256)."""
    ev, od = a[0::2], a[1::2]
    e, o = [0] * 16, [0] * 15
    mul_row(e, 0, ev, b[0])
    mul_row(o, 0, od, b[0])
    for i in range(1, 8):
        if i & 1:
            mad_row(o, i - 1, ev, b[i], True)
            mad_row(e, i + 1, od, b[i], False)
        else:
            mad_row(e, i, ev, b[i], True)
            mad_row(o, i, od, b[i], False)
    merge(e, o)
    return reduce(e)


def sqr(a):
    """fw_sqr: the cross products in two accumulators, doubled, then the
    squares on the diagonal."""
    v = a
    e, o = [0] * 16, [0] * 15
    mul_row(o, 0, [v[1], v[3], v[5], v[7]], v[0])
    mul_row(e, 2, [v[2], v[4], v[6]], v[0])
    mad_row(o, 2, [v[2], v[4], v[6]], v[1], True)
    mad_row(e, 4, [v[3], v[5], v[7]], v[1], False)
    mad_row(o, 4, [v[3], v[5], v[7]], v[2], False)
    mad_row(e, 6, [v[4], v[6]], v[2], True)
    mad_row(o, 6, [v[4], v[6]], v[3], True)
    mad_row(e, 8, [v[5], v[7]], v[3], False)
    mad_row(o, 8, [v[5], v[7]], v[4], False)
    mad_row(e, 10, [v[6]], v[4], True)
    mad_row(o, 10, [v[6]], v[5], True)
    mad_row(e, 12, [v[7]], v[5], False)
    mad_row(o, 12, [v[7]], v[6], False)
    merge(e, o)
    assert e[0] == 0 and from_words(e) < 1 << 511
    cc = CC()
    for k in range(1, 16):
        e[k] = cc.add(e[k], e[k], k > 1, k < 15)
    cc = CC()
    for k in range(8):
        e[2 * k] = cc.add(lo(v[k], v[k]), e[2 * k], k > 0, True)
        e[2 * k + 1] = cc.add(hi(v[k], v[k]), e[2 * k + 1], True, k < 7)
    return reduce(e)


def sub(a, b):
    """fw_sub: a - b mod p for a < 2^256 and b < p, in [0, 2^256)."""
    assert from_words(b) < P
    cc = CC()
    r = [cc.sub(a[k], b[k], k > 0, True) for k in range(8)]
    m = M32 if cc.c else 0  # subc.u32 m, 0, 0
    cc = CC()
    r[0] = cc.sub(r[0], m & 977, False, True)
    r[1] = cc.sub(r[1], m & 1, True, True)
    for k in range(2, 8):
        r[k] = cc.sub(r[k], 0, True, k < 7)
    return r


def canon_lo(a):
    """fw_canon_lo: the low two words of a mod p for a < 2^256."""
    d = from_words(a) + 2**32 + 977
    ge = d >> 256
    return to_words(d - 2**256 if ge else from_words(a))[:2]
