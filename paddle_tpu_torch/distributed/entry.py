"""Sparse-table entry policies — the port's copy of
``paddle_tpu/distributed/entry.py`` (reference distributed/entry_attr.py):
when a new id is admitted into the PS table."""


class ProbabilityEntry:
    """Admit new ids with probability p (show-click CTR tables)."""

    def __init__(self, probability):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self.probability = probability

    def _to_attr(self):
        return f"probability_entry:{self.probability}"


class CountFilterEntry:
    """Admit an id after it has been seen count_filter times."""

    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self.count_filter = int(count_filter)

    def _to_attr(self):
        return f"count_filter_entry:{self.count_filter}"
