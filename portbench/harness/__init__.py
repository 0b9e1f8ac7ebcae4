"""The benchmark's harness: the cell's files found by name (``spec``), the
run's record (``record``), the traced slice (``trace``), the answers'
sampling and judgement (``check``), the card (``device``), the JAX check
(``imports``) and the program's entry points (``program``, the one module
that imports it)."""
