"""Breakup efficiencies (parity: reference
``PySDM/dynamics/collisions/breakup_efficiencies/``)."""


class ConstEb:
    required_attributes = ()

    def __init__(self, Eb=1.0):
        self.Eb = Eb

    def register(self, builder):
        pass

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.Eb
