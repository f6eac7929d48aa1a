"""Host I/O: Arrow/Parquet read-write and the columnar batch."""
