"""The tuner's cost model: for now the two wire-byte formulas that
``Engine.sparse_wire_bytes_per_step`` reads."""
