"""Work of one greedy NMS call (K1, csrc/nms.cu) at its inputs: every pair
of valid candidates is tested once (10 float32 operations: the
intersection's four extrema, two extents, their product, the union's
two terms, the comparison; and 3 per box for its area), and the sorted
boxes (16 bytes), their validity (1 byte) and the keep mask (1 byte) move
once.  The kernel's own bitmask is scratch and is not counted."""

def work(n: int, n_valid: int):
    ops = 10 * n_valid * (n_valid - 1) // 2 + 3 * n_valid
    return ops, 18 * n
