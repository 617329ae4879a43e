"""Query execution: tokens, decrypt-and-refine service, evaluation."""
