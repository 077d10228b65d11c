"""BCCF baseline build, forest flattening and the bounded forest search."""
