"""Launch drivers beyond one resident launch: `cohort.py` pages the
fleet's wire between host memory and one card."""
