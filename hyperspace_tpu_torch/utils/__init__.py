"""Cross-cutting utilities (reference: ``util/*.scala``)."""
