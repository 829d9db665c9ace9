"""Test suite (a regular package, so ``tests.*`` imports resolve here
and never to another installed package named ``tests``)."""
