"""Plan analysis: explain, whyNot, the filter-reason catalog, statistics and
the min/max layout analysis."""
