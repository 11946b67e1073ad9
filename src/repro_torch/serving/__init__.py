"""Serving on the card: the budgeted weight pool, the engine and its
framework-free scheduling, batching and reporting layers."""
