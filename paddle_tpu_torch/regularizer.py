"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

Passed as an optimizer's ``weight_decay`` (or a parameter group's):
``L2Decay(c)`` adds ``c * p`` to the gradient, as a float ``c`` does;
``L1Decay(c)`` adds ``c * sign(p)``.
"""


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __float__(self):
        return self.coeff

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __float__(self):
        return self.coeff

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"
