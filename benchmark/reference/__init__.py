"""The plain reference: graph build and training steps in numpy and plain torch."""
