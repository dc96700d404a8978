"""SFMT19937 state recovery from truncated outputs.

Beyond-the-reference model family (gf2bv_tpu/crypto/sfmt.py; the reference
ships only the scalar MT19937 — ``/root/reference/gf2bv/crypto/mt.py``).
SFMT has no output tempering, so the observed words ARE state words; the
attack content is entirely in the truncation: here the victim leaks only
the low 16 bits of each draw, and the 128-bit-lane recursion ties the
unseen halves together across blocks.  19968 unknowns — exactly the
flagship MT shape the blocked device solver is tuned for.
"""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import random

from gf2bv_tpu import LinearSystem
from gf2bv_tpu.crypto.sfmt import SFMT19937
from gf2bv_tpu.utils.timing import timeit

# 4 blocks of low-16 leaks (39936 equations): enough to pin every state
# direction that influences the future.  SFMT19937's 19968-bit state has a
# 31-dim (19968 - MEXP) subspace that the transition annihilates and the
# truncation hides, so the contract is exact PREDICTION, not raw state
# equality.
N_OUT = 2496


def main():
    victim = SFMT19937.from_seed(20260819)
    # burn an arbitrary prefix; the attacker models the state at the next
    # block boundary (the in-block cursor is observable mod N32 anyway)
    for _ in range(624 * 3):
        victim()
    observed = [victim() & 0xFFFF for _ in range(N_OUT)]

    lin = LinearSystem([32] * 624)
    with timeit("generate system"):
        sym = SFMT19937(list(lin.gens()), index=624)
        zeros = [(sym() & 0xFFFF) ^ o for o in observed]

    with timeit("solve_one"):
        state = lin.solve_one(zeros)
    assert state is not None
    print(f"recovered state head: {state[:6]}")

    # the clone replays the leak and predicts the victim's future in full
    clone = SFMT19937(list(state), index=624)
    assert observed == [clone() & 0xFFFF for _ in range(N_OUT)]
    assert all(clone() == victim() for _ in range(1000))
    print("future outputs predicted exactly")


if __name__ == "__main__":
    main()
