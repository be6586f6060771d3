"""Main-path constitutive suite: batched Voigt models on tensors."""
from .base import NonElasticElement
from .elastic import Spring
from .material import Material
from .creep import DislocationCreep, Viscoelastic
from .viscoplastic import ViscoplasticDesai

__all__ = ["NonElasticElement", "Spring", "Material", "DislocationCreep",
           "Viscoelastic", "ViscoplasticDesai"]
