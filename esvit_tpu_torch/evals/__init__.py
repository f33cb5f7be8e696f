"""Evaluation protocols on frozen features: k-NN (knn.py) and the linear
probe (linear.py), over the shared extraction machinery (extract.py)."""
