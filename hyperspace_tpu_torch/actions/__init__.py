"""Index lifecycle actions (the begin/op/end protocol over the log)."""
