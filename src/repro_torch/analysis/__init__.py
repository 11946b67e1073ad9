"""Dry-run analysis: the HLO text parser, roofline terms, report tables."""
