"""Constitutive suite: batched Voigt models on tensors."""
from .base import NonElasticElement
from .elastic import Spring, Thermoelastic
from .material import Material
from .creep import (DislocationCreep, MunsonDawsonCreep,
                    PressureSolutionCreep, Viscoelastic)
from .viscoplastic import (MatsuokaNakaiViscoplastic,
                           MohrCoulombViscoplastic, ViscoplasticDesai)

__all__ = ["NonElasticElement", "Spring", "Thermoelastic", "Material",
           "DislocationCreep", "PressureSolutionCreep", "MunsonDawsonCreep",
           "Viscoelastic", "ViscoplasticDesai", "MohrCoulombViscoplastic",
           "MatsuokaNakaiViscoplastic"]
