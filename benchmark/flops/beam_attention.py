"""Work of one call of BLIP-2's beam decode attention (csrc/beam_attention.cu)
at its inputs, from the shapes and the step alone: b crops of k beams, h
heads of width hd, a prefix of p positions that a crop's beams share, and
each beam's own positions 0..step, read through the ancestry table.

Bytes: the prefix's keys and values once per crop, each beam's own keys
and values of positions 0..step once, its row of the ancestry table
(int32) up to the step, the query read and the output written once (e
bytes an element).  Operations (float32 rate): per beam, head and one of
its L = p + step + 1 positions, the score (hd multiply-adds), its share
of the softmax (a subtraction, an exponential, a sum and a scaling) and
the weighted sum of values (hd multiply-adds)."""


def work(b: int, k: int, h: int, p: int, hd: int, e: int, step: int):
    n = step + 1
    length = p + n
    ops = b * k * h * length * (4 * hd + 4)
    nbytes = (2 * h * hd * e * (b * p + b * k * n)   # keys and values
              + 4 * b * k * n                        # the ancestry table
              + 2 * b * k * h * hd * e)              # query and output
    return ops, nbytes
