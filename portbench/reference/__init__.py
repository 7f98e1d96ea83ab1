"""The plain reference: TUPSK sketches, the sketch join, the four
estimators and the ranking, rebuilt from the benchmark's raw tables in
plain PyTorch.  It imports nothing of the program."""
