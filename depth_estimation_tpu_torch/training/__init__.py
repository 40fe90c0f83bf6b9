"""Training: SGD with torch-optim semantics, criteria, samplers, trainers, scoring."""
