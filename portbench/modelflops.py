"""Model FLOPs of the work a cell completes, from the reference's
``flops_terms(arch) -> (a, b, u)`` (see the reference modules): a token
at context position ``c`` costs ``a + b (c + 1)``, and each logit row
``u``.  Only useful work counts: real prompt tokens, never the padding,
and one logit row per generated token."""


def _tokens(a, b, first, n):
    """Tokens at positions first .. first + n - 1."""
    return n * a + b * (n * first + n * (n + 1) // 2)


def served(terms, prompt: int, generated: int) -> float:
    """A served request: its prefill, then ``generated - 1`` decode steps,
    one logit row per generated token."""
    a, b, u = terms
    return (_tokens(a, b, 0, prompt) + _tokens(a, b, prompt, generated - 1)
            + u * generated)
