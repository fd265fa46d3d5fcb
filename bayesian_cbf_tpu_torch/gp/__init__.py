from .algebra import (GP, DeterministicGP, LeafGP, GradientGP,
                      AddGP, ScaleGP, DotDetGP, DotGP, TransposeGP)

__all__ = ["GP", "DeterministicGP", "LeafGP", "GradientGP",
           "AddGP", "ScaleGP", "DotDetGP", "DotGP", "TransposeGP"]
