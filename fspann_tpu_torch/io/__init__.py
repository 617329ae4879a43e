"""Data ingestion: vector file formats, synthetic corpora, ground truth."""
