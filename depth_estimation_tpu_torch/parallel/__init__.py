"""Data-parallel and row-sharded execution over the cards of one host."""
