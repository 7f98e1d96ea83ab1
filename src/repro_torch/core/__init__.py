"""Sketching, joins and MI estimators of the PyTorch port."""
