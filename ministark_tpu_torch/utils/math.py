"""Small integer math helpers.

Semantics mirror the reference's ``src/util.rs:1-44`` exactly (including the
``ceil_log2_k(1, _) == 1`` special case) because the derived values feed the
protocol parameter math and therefore the transcript shape.
"""


def is_power_of_two(number: int) -> bool:
    """True for 0 and every power of two (reference: src/util.rs:4-14)."""
    if number > 0:
        return number & (number - 1) == 0
    return number == 0


def logarithm_of_two_k(number: int, base: int) -> int:
    """Exact logarithm of ``number`` in base ``base`` (a power of two).

    Raises ``ValueError`` with the reference's exact error strings
    (reference: src/util.rs:16-28 — including the "number if" typo).
    """
    assert is_power_of_two(base)
    log_n = (base & -base).bit_length() - 1  # trailing_zeros
    if not is_power_of_two(number) or number == 0:
        raise ValueError("number if not a power of 2")
    power_of_two = (number & -number).bit_length() - 1
    if power_of_two % log_n != 0:
        raise ValueError("number if not a power of base")
    return power_of_two // log_n


def ceil_log2_k(number: int, base: int) -> int:
    """Log base-2 of ``number`` rounded up to a multiple of log2(base).

    Mirrors reference src/util.rs:30-44: for powers of two whose log2 is a
    multiple of log2(base) it returns log2(number); otherwise it rounds the
    bit-length up to a multiple of log2(base). Special case: number == 1 -> 1.
    """
    assert is_power_of_two(base)
    assert number != 0
    if number == 1:
        return 1
    log2_base = (base & -base).bit_length() - 1
    log2_number = (number & -number).bit_length() - 1  # trailing_zeros
    if is_power_of_two(number) and log2_number % log2_base == 0:
        return log2_number
    next_power_2 = number.bit_length()  # usize::BITS - leading_zeros
    return -(-next_power_2 // log2_base) * log2_base
