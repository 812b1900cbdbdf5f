"""The benchmark's plain reference: what a Zinc proof and a sumcheck proof
must say, worked out in Python ints and numpy from the inputs the benchmark
made.  It imports nothing of the program: the transcript's hash, the prime
drawing, the RAA code's permutations and BLAKE3 are copies or plain
rewrites of the published algorithms, and every field operation is a
Python-int operation mod q.
"""
