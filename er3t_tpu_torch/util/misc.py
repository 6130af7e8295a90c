"""Small L1 utilities (reference er3t/util/util.py counterparts).

A copy of ``er3t_tpu/util/misc.py`` (:1-75), function for function.
"""

from __future__ import annotations

import numpy as np

__all__ = ['nice_array_str', 'h5dset_to_pydict', 'send_email']


def nice_array_str(array1d, num_per_line=6):
    """1-D array -> aligned multi-line string (reference util.py:191-220)."""
    array1d = np.asarray(array1d)
    if array1d.ndim > 1:
        raise ValueError('nice_array_str: only 1-D arrays are supported')
    lines = []
    for i in range(0, array1d.size, num_per_line):
        lines.append(''.join('  %12g' % v
                             for v in array1d[i:i + num_per_line]))
    return '\n'.join(lines)


def h5dset_to_pydict(dset):
    """h5py dataset -> the framework's {'data', 'name', 'units'} dict
    (reference h5dset_to_pydict, util.py:225)."""
    attrs = {k: (v.decode() if isinstance(v, bytes) else v)
             for k, v in dset.attrs.items()}
    return {
        'data': dset[()],
        'name': attrs.get('name', dset.name.split('/')[-1]),
        'units': attrs.get('units', 'N/A'),
        **{k: v for k, v in attrs.items() if k not in ('name', 'units')},
    }


def send_email(content=None, files=None, receiver=None,
               sender=None, password=None, smtp_host=None, smtp_port=587):
    """Email notifier (reference send_email, util.py:134).

    Unlike the reference (which ships hardcoded account credentials in the
    source), sender/password/host must come from the environment:
    ER3T_SMTP_HOST / ER3T_SMTP_USER / ER3T_SMTP_PASS / ER3T_EMAIL_TO.
    """
    import os
    import smtplib
    import socket
    import datetime
    from email.mime.text import MIMEText
    from email.mime.multipart import MIMEMultipart
    from email.mime.application import MIMEApplication

    smtp_host = smtp_host or os.environ.get('ER3T_SMTP_HOST')
    sender = sender or os.environ.get('ER3T_SMTP_USER')
    password = password or os.environ.get('ER3T_SMTP_PASS')
    receiver = receiver or os.environ.get('ER3T_EMAIL_TO')
    if not (smtp_host and sender and receiver):
        raise ValueError('send_email needs ER3T_SMTP_HOST/ER3T_SMTP_USER/'
                         'ER3T_EMAIL_TO (and usually ER3T_SMTP_PASS)')

    msg = MIMEMultipart()
    msg['From'] = sender
    msg['To'] = receiver
    msg['Subject'] = (f'er3t_tpu@{socket.gethostname()} '
                      f'{datetime.datetime.now():%Y-%m-%d %H:%M:%S}')
    msg.attach(MIMEText(content or ''))
    for fn in (files or []):
        with open(fn, 'rb') as fh:
            part = MIMEApplication(fh.read(), Name=fn.split('/')[-1])
        part['Content-Disposition'] = f'attachment; filename="{fn}"'
        msg.attach(part)

    with smtplib.SMTP(smtp_host, smtp_port) as s:
        s.starttls()
        if password:
            s.login(sender, password)
        s.sendmail(sender, receiver, msg.as_string())
