"""Plain PyTorch references of the benchmark's configurations. They import
no module of the program under test."""
