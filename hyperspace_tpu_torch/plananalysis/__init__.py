"""Plan analysis: explain and the filter-reason catalog."""
