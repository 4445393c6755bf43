"""Physical constants (SI).

Values mirror the reference's ablastr constants so that double-precision physics
matches reference checksums (reference: Source/ablastr/constant.H:23-83, CODATA 2018).
"""

import math

# Mathematical constants
pi = 3.14159265358979323846
tau = 2.0 * pi

# SI physical constants (CODATA 2018)
c = 299_792_458.0                 # vacuum speed of light [m/s]
ep0 = 8.8541878128e-12            # vacuum permittivity [F/m]
mu0 = 1.25663706212e-06           # vacuum permeability [H/m]
q_e = 1.602176634e-19             # elementary charge [C]
m_e = 9.1093837015e-31            # electron mass [kg]
m_p = 1.67262192369e-27           # proton mass [kg]
m_u = 1.66053906660e-27           # unified atomic mass unit [kg]
hbar = 1.054571817e-34            # reduced Planck constant [J*s]
alpha = 0.007297352573748943      # fine-structure constant
r_e = 2.817940326204929e-15       # classical electron radius [m]
xi = 1.3050122447005176e-52       # Heisenberg-Euler nonlinearity parameter
xi_c2 = 1.1728865132395492e-35    # xi * c^2
kb = 1.380649e-23                 # Boltzmann constant [J/K]

eV = q_e
MeV = q_e * 1e6
eV_invc = eV / c
MeV_invc = MeV / c
eV_invc2 = eV / (c * c)
MeV_invc2 = MeV / (c * c)

inv_c2 = 1.0 / (c * c)

# Names available inside input-deck math expressions, matching the reference
# parser's predefined constants (reference: Source/Utils/Parser/ParserUtils.cpp
# `addConstantsToParser`: q_e, m_e, m_p, m_u, epsilon0, mu0, clight, kb, pi).
EXPRESSION_CONSTANTS = {
    "q_e": q_e,
    "m_e": m_e,
    "m_p": m_p,
    "m_u": m_u,
    "epsilon0": ep0,
    "mu0": mu0,
    "clight": c,
    "kb": kb,
    "pi": pi,
    "inf": math.inf,
}
