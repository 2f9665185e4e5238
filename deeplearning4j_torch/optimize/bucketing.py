"""Shape bucketing (copied from ``deeplearning4j_tpu/optimize/bucketing.py``):
``bucket_length`` and ``bucket_pages``, with the ``bucket_rows`` helper they
share. The port runs eagerly and compiles nothing per shape; the buckets
keep the serving schedule (and so its outputs) identical to the JAX
server's."""

from __future__ import annotations


def bucket_rows(n: int, multiple: int = 1) -> int:
    """The smallest power of two >= n, rounded up to a ``multiple``."""
    if n < 1:
        raise ValueError(f"batch must have at least one row, got {n}")
    b = 1
    while b < n:
        b *= 2
    if multiple > 1 and b % multiple:
        b = -(-b // multiple) * multiple
    return b


def bucket_length(n: int, minimum: int = 8,
                  maximum: "int | None" = None) -> int:
    """Canonical padded TIME length for an ``n``-token sequence: the
    smallest power of two >= max(n, minimum), capped at ``maximum``."""
    if maximum is not None and n > maximum:
        raise ValueError(f"sequence of {n} tokens exceeds the maximum "
                         f"bucketed length {maximum}")
    b = bucket_rows(max(int(n), int(minimum)))
    if maximum is not None and b > maximum:
        b = int(maximum)
    return b


def bucket_pages(n: int, page_size: int,
                 maximum: "int | None" = None) -> int:
    """Number of fixed-size KV pages covering ``n`` tokens, rounded up to a
    power of two and capped at ``maximum`` pages; ``n`` itself exceeding
    ``maximum * page_size`` tokens is the caller's admission error."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if n < 1:
        raise ValueError(f"need at least one token, got {n}")
    pages = bucket_rows(-(-int(n) // int(page_size)))
    if maximum is not None:
        if n > maximum * page_size:
            raise ValueError(
                f"sequence of {n} tokens exceeds the page budget "
                f"{maximum} pages x {page_size}")
        if pages > maximum:
            pages = int(maximum)
    return pages
